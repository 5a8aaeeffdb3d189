"""Dataset zoo: download, caching and a dataset and loader factory per dataset
(torch-em data/datasets/), the port's own copy of ``torch_em_tpu/data/datasets/``: four domains,
electron_microscopy, light_microscopy, histopathology and medical.
The loaders return the port's ``DataLoader`` of torch tensors.
"""

from . import util
from .electron_microscopy import *  # noqa: F401,F403
from .light_microscopy import *  # noqa: F401,F403
from .histopathology import *  # noqa: F401,F403
from .medical import *  # noqa: F401,F403
