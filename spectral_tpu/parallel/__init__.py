from .distributed import init_distributed, local_row_block, make_global_mesh
from .mesh import SAMPLE_AXIS, TILE_AXIS, factor_devices, make_mesh
from .render import (
    apply_params,
    image_loss,
    render_image_sharded,
    render_image_sharded_pallas,
    train_step,
    trainable_params,
)

__all__ = [
    "SAMPLE_AXIS",
    "TILE_AXIS",
    "init_distributed",
    "local_row_block",
    "make_global_mesh",
    "factor_devices",
    "make_mesh",
    "apply_params",
    "image_loss",
    "render_image_sharded",
    "render_image_sharded_pallas",
    "train_step",
    "trainable_params",
]
