from .convert import state_dict_from_jax_params
from .io import RoiWrapper, load_data
from .prediction import Blocking, predict_with_halo, predict_with_padding

__all__ = [
    "Blocking", "predict_with_halo", "predict_with_padding", "state_dict_from_jax_params",
    "RoiWrapper", "load_data",
]
