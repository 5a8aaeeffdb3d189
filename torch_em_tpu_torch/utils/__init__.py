from .convert import state_dict_from_jax_params
from .io import RoiWrapper, get_dataset_shape, load_data, open_container, write_data
from .prediction import Blocking, predict_with_halo, predict_with_padding

__all__ = [
    "Blocking", "predict_with_halo", "predict_with_padding", "state_dict_from_jax_params",
    "RoiWrapper", "load_data", "open_container", "get_dataset_shape", "write_data",
]
