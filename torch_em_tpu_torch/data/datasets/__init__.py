"""Dataset zoo: download, caching and a dataset and loader factory per dataset
(torch-em data/datasets/), the port's own copy of ``torch_em_tpu/data/datasets/``.
The loaders return the port's ``DataLoader`` of torch tensors.
"""

from . import util
from .electron_microscopy import *  # noqa: F401,F403
from .light_microscopy import *  # noqa: F401,F403

# histopathology and medical are not ported yet: they follow, one domain at a time, in that order
# (ROADMAP.md, Queue 1)
