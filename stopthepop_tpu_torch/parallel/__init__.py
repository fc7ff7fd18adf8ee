"""Multi-device scaling over torch.distributed: the ("data", "gauss") train
step, band-sharded and ring-streamed rendering and training, and the
process-group bring-up (the port of ``stopthepop_tpu/parallel/``)."""

from . import hosts  # noqa: F401

from .spatial import (  # noqa: F401
    band_render,
    make_spatial_render,
    make_spatial_train_step,
    plan_bands,
    spatial_rgb_loss,
)
from .spatial import shard_model as shard_model_spatial  # noqa: F401
from .train import make_mesh, make_sharded_train_step, shard_model  # noqa: F401
