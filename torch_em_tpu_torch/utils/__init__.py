from .convert import state_dict_from_jax_params
from .io import RoiWrapper, get_dataset_shape, load_data, load_image, open_container, supports_memmap, write_data
from .prediction import Blocking, predict_with_halo, predict_with_padding
from .util import (
    auto_compile, get_constructor_arguments, get_normalizer, get_random_colors, get_trainer, is_compiled,
    load_model, model_is_equal,
)

__all__ = [
    "Blocking", "predict_with_halo", "predict_with_padding", "state_dict_from_jax_params",
    "RoiWrapper", "load_data", "load_image", "supports_memmap", "open_container", "get_dataset_shape",
    "write_data", "get_trainer", "get_normalizer", "load_model", "model_is_equal", "get_constructor_arguments",
    "get_random_colors", "is_compiled", "auto_compile",
]
