"""stopthepop_tpu_torch: the PyTorch/CUDA port of stopthepop_tpu.

A second package beside the JAX one, held against it on the same inputs.
It renders and trains in the GLOBAL, PER_PIXEL_KBUFFER and HIERARCHICAL sort
modes and renders in PER_PIXEL_FULL (every stream order, rect /
tight-opacity / tile-based culling, proper EWA scaling) with the blends in
hand-written CUDA kernels for Hopper (``csrc/``: K1/K2 GLOBAL
forward/backward, K3/K4 k-buffer forward/backward, K5/K6 hierarchical
forward/backward, K7 the exact per-pixel sort, forward only; small
PER_PIXEL_FULL scenes also through the dense differentiable oracle,
``full_mode``). Around the render: COLMAP and NeRF-synthetic captures
(``io/colmap.py``, ``io/images.py``) for both CLIs, their PNG frames and
the PLY models read and written by C++ codecs (``native/``, built with g++
at first use by ``kernels/build.py::build_host``), single- and
multi-camera training steps (``train/trainer.py``), the dense oracles of
every mode with the reference's sort-error maps (``render/naive.py``), the
six debug visualization modes and ``render_depth``
(``render/debug_viz.py``), ``debug=True`` failure snapshots
(``utils/snapshot.py``), the program's ``stp/`` spans for each layer of a
frame and a training step in any ``torch.profiler`` trace, and the stage
timer that times them in every sort mode (``utils/profiling.py``,
``render/pipeline.py::render_tiled_timed``). Across GPUs, over
torch.distributed (``parallel/``): the ("data", "gauss") train step,
band-sharded rendering and training, the ring-streamed Gaussian shards and
the process-group bring-up, one process per GPU.
Entry points run on the GPU unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper runs its plain PyTorch version. On the
CPU, ``python -m pytest tests/test_torch_*.py`` holds the port against the
JAX package; on an H100, ``python3 chip_smoke.py`` builds the kernels and
drives every path (phases ``train_batched``, ``colmap``, ``debug_viz``,
``timed``, ``snapshot``, ``parallel`` and ``io`` for the ones above).

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
    FULL_MODES,
    GaussianRasterizer,
    RenderOutput,
    rasterize_gaussians,
)

__version__ = "0.1.0"
