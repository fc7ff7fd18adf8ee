"""stopthepop_tpu_torch: the PyTorch/CUDA port of stopthepop_tpu.

A second package beside the JAX one, held against it on the same inputs.
This slice renders the GLOBAL sort mode forward (Z_DEPTH and DISTANCE
orders, rect / tight-opacity culling, proper EWA scaling) with the blend in
a hand-written CUDA kernel for Hopper (``csrc/global_blend_fwd.cu``). Entry
points run on the GPU unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper runs its plain PyTorch version.

Nothing here imports JAX or the ``stopthepop_tpu`` package.
"""

from .config import (  # noqa: F401
    CullingSettings,
    DebugVisualization,
    ExtendedSettings,
    GaussianRasterizationSettings,
    GlobalSortOrder,
    SortMode,
    SortQueueSizes,
    SortSettings,
)
from .ops.transforms import mark_visible  # noqa: F401
from .render.rasterize import (  # noqa: F401
    GaussianRasterizer,
    RenderOutput,
    rasterize_gaussians,
)

__version__ = "0.1.0"
