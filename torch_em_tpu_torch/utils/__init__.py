from .convert import state_dict_from_jax_params
from .training import parser_helper
from .io import RoiWrapper, get_dataset_shape, load_data, load_image, open_container, supports_memmap, write_data
from .prediction import Blocking, predict_with_halo, predict_with_padding
from .reporting import get_training_summary
from .segmentation import (
    connected_components_with_boundaries, mutex_watershed_segmentation, size_filter,
    watershed_from_center_and_boundary_distances, watershed_from_components, watershed_from_maxima,
)
from .tensor import (
    ensure_array, ensure_array_with_channels, ensure_patch_shape, ensure_spatial_array, validate_roi,
)
from .util import (
    auto_compile, get_constructor_arguments, get_normalizer, get_random_colors, get_trainer, is_compiled,
    load_model, model_is_equal,
)

__all__ = [
    "Blocking", "predict_with_halo", "predict_with_padding", "state_dict_from_jax_params", "parser_helper",
    "RoiWrapper", "load_data", "load_image", "supports_memmap", "open_container", "get_dataset_shape",
    "write_data", "get_trainer", "get_normalizer", "load_model", "model_is_equal", "get_constructor_arguments",
    "get_random_colors", "is_compiled", "auto_compile", "connected_components_with_boundaries",
    "mutex_watershed_segmentation", "size_filter", "watershed_from_center_and_boundary_distances",
    "watershed_from_components", "watershed_from_maxima", "get_training_summary", "ensure_array",
    "ensure_array_with_channels", "ensure_patch_shape", "ensure_spatial_array", "validate_roi",
]
