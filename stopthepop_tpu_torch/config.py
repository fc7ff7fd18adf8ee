"""Settings / configuration system (PyTorch port).

A copy of ``stopthepop_tpu/config.py``, which is pure Python: the same
dataclass names, field names, enum values, ``set_value`` flat-key routing and
JSON round-trip as the reference's settings tree
(diff_gaussian_rasterization/__init__.py:175-263), so sweep scripts written
against the reference work unchanged. The port keeps its own copy because
importing any ``stopthepop_tpu`` module loads JAX.

``GaussianRasterizationSettings`` holds torch tensors (bg, matrices, campos).
``load_balancing`` is accepted for parity and has no effect.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from enum import IntEnum
from typing import Any, NamedTuple


def _enum_dict_factory(data):
    def convert(obj):
        if isinstance(obj, IntEnum):
            return obj.value
        return obj

    return {k: convert(v) for k, v in data}


class SortMode(IntEnum):
    """Reference: __init__.py:175-179 / rasterizer.h SortMode."""

    GLOBAL = 0
    PPX_FULL = 1
    PPX_KBUFFER = 2
    HIER = 3

    # Aliases matching the C++ enum names (rasterizer.h).
    PER_PIXEL_FULL = 1
    PER_PIXEL_KBUFFER = 2
    HIERARCHICAL = 3

    def __str__(self):
        return self.name


class GlobalSortOrder(IntEnum):
    """Reference: __init__.py:184-189 / rasterizer.h GlobalSortOrder."""

    Z_DEPTH = 0
    DISTANCE = 1
    PTD_CENTER = 2
    PTD_MAX = 3

    # C++ enum aliases.
    VIEWSPACE_Z = 0
    PER_TILE_DEPTH_CENTER = 2
    PER_TILE_DEPTH_MAXPOS = 3

    def __str__(self):
        return self.name


@dataclass
class SortQueueSizes:
    """Reference: __init__.py:193-201; defaults rasterizer.h:43-48."""

    tile_4x4: int = 64
    tile_2x2: int = 8
    per_pixel: int = 4

    def set_value(self, key, value):
        if key in self.__dataclass_fields__.keys():
            self.__setattr__(key, value)


@dataclass
class SortSettings:
    """Reference: __init__.py:203-213."""

    queue_sizes: SortQueueSizes = field(default_factory=SortQueueSizes)
    sort_mode: SortMode = SortMode.GLOBAL
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH

    def set_value(self, key, value):
        if key in self.__dataclass_fields__.keys():
            self.__setattr__(key, value)
        else:
            self.queue_sizes.set_value(key, value)


@dataclass
class CullingSettings:
    """Reference: __init__.py:215-224."""

    rect_bounding: bool = False
    tight_opacity_bounding: bool = False
    tile_based_culling: bool = False
    hierarchical_4x4_culling: bool = False

    def set_value(self, key, value):
        if key in self.__dataclass_fields__.keys():
            self.__setattr__(key, value)


@dataclass
class ExtendedSettings:
    """Reference: __init__.py:226-246."""

    sort_settings: SortSettings = field(default_factory=SortSettings)
    culling_settings: CullingSettings = field(default_factory=CullingSettings)
    load_balancing: bool = False
    proper_ewa_scaling: bool = False

    def to_dict(self) -> dict:
        return asdict(self, dict_factory=_enum_dict_factory)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "ExtendedSettings":
        sort = d.get("sort_settings", {})
        queues = sort.get("queue_sizes", {})
        culling = d.get("culling_settings", {})
        return ExtendedSettings(
            sort_settings=SortSettings(
                queue_sizes=SortQueueSizes(
                    tile_4x4=int(queues.get("tile_4x4", 64)),
                    tile_2x2=int(queues.get("tile_2x2", 8)),
                    per_pixel=int(queues.get("per_pixel", 4)),
                ),
                sort_mode=SortMode(sort.get("sort_mode", 0)),
                sort_order=GlobalSortOrder(sort.get("sort_order", 0)),
            ),
            culling_settings=CullingSettings(
                rect_bounding=bool(culling.get("rect_bounding", False)),
                tight_opacity_bounding=bool(
                    culling.get("tight_opacity_bounding", False)
                ),
                tile_based_culling=bool(culling.get("tile_based_culling", False)),
                hierarchical_4x4_culling=bool(
                    culling.get("hierarchical_4x4_culling", False)
                ),
            ),
            load_balancing=bool(d.get("load_balancing", False)),
            proper_ewa_scaling=bool(d.get("proper_ewa_scaling", False)),
        )

    @staticmethod
    def from_json(json_filename: str) -> "ExtendedSettings":
        with open(json_filename) as f:
            return ExtendedSettings.from_dict(json.load(f))

    def set_value(self, key, value):
        if key in self.__dataclass_fields__.keys():
            self.__setattr__(key, value)
        else:
            self.culling_settings.set_value(key, value)
            self.sort_settings.set_value(key, value)


class GaussianRasterizationSettings(NamedTuple):
    """Per-call rasterization settings over torch tensors.

    Mirrors the reference NamedTuple (__init__.py:248-263). Matrices use the
    reference's (torch 3DGS) convention: ``viewmatrix``/``projmatrix`` are the
    *transposed* world-to-view / world-to-clip matrices, so points transform as
    ``p_out = p_hom @ M``. The rasterizer moves the tensors to the device of
    the Gaussians it renders.
    """

    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: Any  # [3] float32 tensor
    scale_modifier: float
    viewmatrix: Any  # [4, 4] float32 tensor
    projmatrix: Any  # [4, 4] float32 tensor
    inv_viewprojmatrix: Any  # [4, 4] float32 tensor
    sh_degree: int
    campos: Any  # [3] float32 tensor
    prefiltered: bool
    settings: ExtendedSettings
    render_depth: bool = False
    debug: bool = False


class DebugVisualization(IntEnum):
    """Reference: stopthepop/rasterizer_debug.h:11-20."""

    Disabled = 0
    SortErrorOpacity = 1
    SortErrorDistance = 2
    GaussianCountPerTile = 3
    GaussianCountPerPixel = 4
    Depth = 5
    Transmittance = 6
