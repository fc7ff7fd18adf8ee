"""The pair-stream kernels' dispatch and interface, on the CPU.

The kernels (``csrc/pairs.cu``, wrapped by ``kernels/pairs.py``) run only on
the card, where ``chip_smoke.py`` (phase kernel_pairs) holds every
``PairBuffer`` field against the torch path at the benchmark's shapes, and
the card case below at a small one. Here: the rule that picks them
(``takes_kernel``), that CPU tensors take the torch path and launch nothing,
the sort's key bits (``end_bit``), that the ctypes binding matches the C
interface, that the library's name hashes the source, and that the
dispatch hands the kernels' wrappers the call, builds the buffer from what
they return and opens the torch path's spans. The torch path is the plain
version the card case holds the kernels against.

This file imports no JAX, so that its card case runs where JAX is absent
(``python -m pytest --noconftest tests/test_torch_pairs_kernel.py -m card``).
"""

import ctypes
import re
import shutil
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stopthepop_tpu_torch.config import GlobalSortOrder
from stopthepop_tpu_torch.kernels import build
from stopthepop_tpu_torch.kernels import pairs as kp
from stopthepop_tpu_torch.render import duplicate
from stopthepop_tpu_torch.render.duplicate import (
    PairBuffer,
    build_pairs,
    expand_pairs,
    sort_expanded,
)
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

ORDERS = list(GlobalSortOrder)
RULE_CASES = [(dev, order, cull) for dev in ("cuda", "cpu") for order in ORDERS
              for cull in (False, True)]
BINS = [(16, 16), (32, 16)]
KERNEL_ORDERS = [GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _prep(scene_name, order, tile, device="cpu"):
    """(prep, grid_x, grid_y) of a scene: ``random`` (250 Gaussians at
    64x48, about a fifth behind the camera or off the image), ``sparse``
    (12 Gaussians at 160x96: most tiles empty), ``empty`` (no pair) or
    ``zeros`` (``random`` with depths of -0.0 and +0.0 among the others)."""
    n, w, h = {"random": (250, 64, 48), "sparse": (12, 160, 96),
               "empty": (20, 48, 32), "zeros": (250, 64, 48)}[scene_name]
    scene = random_scene(7, n, device="cpu")
    means = scene.means3d.clone()
    means[:3, 2] = -6.0  # behind the camera: tiles_touched 0
    cam = make_camera(w, h, device="cpu")
    with torch.no_grad():
        prep = preprocess(
            means, scene.opacities, scales=scene.scales,
            rotations=scene.rotations, shs=scene.shs,
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            image_width=w, image_height=h, sh_degree=3, sort_order=order,
            rect_bounding=True, tight_opacity_bounding=True,
            tile_x=tile[0], tile_y=tile[1])
    if scene_name == "empty":
        prep = prep._replace(tiles_touched=torch.zeros_like(prep.tiles_touched))
    if scene_name == "zeros":
        depth = prep.depth.clone()
        depth[3:40:2] = -0.0
        depth[4:40:2] = 0.0
        prep = prep._replace(depth=depth)
    prep = type(prep)(*(t.to(device) for t in prep))
    return (prep, *tile_grid(w, h, *tile))


def _torch_path(prep, gx, gy):
    return sort_expanded(*expand_pairs(prep, grid_x=gx), num_tiles=gx * gy,
                         num_gaussians=prep.tiles_touched.shape[0])


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_buffer(got, want):
    """Every field of two PairBuffers equal: dtypes, shapes and bits
    (-0.0 is not 0.0)."""
    assert got.num_rendered == want.num_rendered
    for name in PairBuffer._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "num_rendered":
            continue
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize(
    "device,order,cull", RULE_CASES,
    ids=[f"{d}-{o.name}-cull{int(c)}" for d, o, c in RULE_CASES])
def test_takes_kernel_rule(device, order, cull):
    want = device == "cuda" and order in KERNEL_ORDERS and not cull
    assert kp.takes_kernel(torch.device(device), order, cull) == want
    assert kp.takes_kernel(device, int(order), cull) == want


@pytest.mark.parametrize("order", ORDERS, ids=[o.name for o in ORDERS])
def test_cpu_tensors_take_the_torch_path(monkeypatch, order):
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(duplicate, "duplicate_with_keys", refuse)
    monkeypatch.setattr(duplicate, "sort_and_identify", refuse)
    launches = (kp.duplicate_with_keys.launches, kp.sort_and_identify.launches)
    prep, gx, gy = _prep("random", order, (16, 16))
    cam = make_camera(64, 48, device="cpu")
    kw = dict(campos=cam.campos, inverse_vp=cam.inv_viewprojmatrix,
              image_width=64, image_height=48)
    got = build_pairs(prep, grid_x=gx, grid_y=gy, sort_order=order, **kw)
    want = sort_expanded(*expand_pairs(prep, grid_x=gx, sort_order=order,
                                       **kw),
                         num_tiles=gx * gy,
                         num_gaussians=prep.tiles_touched.shape[0])
    assert_same_buffer(got, want)
    assert (kp.duplicate_with_keys.launches,
            kp.sort_and_identify.launches) == launches


@pytest.mark.parametrize("num_tiles,bits", [(1, 33), (2, 33), (255, 40),
                                            (256, 40), (257, 41),
                                            (4056, 44)])
def test_end_bit_covers_the_largest_tile_id(num_tiles, bits):
    assert kp.end_bit(num_tiles) == bits
    assert (num_tiles - 1) >> (bits - 32) == 0


def test_binding_matches_the_c_interface():
    src = (build.CSRC / f"{kp.KERNEL}.cu").read_text()
    found = dict(re.findall(r'extern "C" int (stp_pairs_\w+)\(([^)]*)\)', src))
    assert sorted(found) == sorted(kp.ENTRIES)
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace(__name__=name) for name in found})
    fns = kp.bind(lib)
    for name, params in found.items():
        ctype = [kp.C_TYPES.get(p.strip().rsplit(" ", 1)[0], ctypes.c_void_p)
                 for p in params.split(",")]
        assert getattr(fns, name[len("stp_pairs_"):]).argtypes == ctype, name


def test_library_path_hashes_the_pairs_source(tmp_path, monkeypatch):
    # Naming only: the build itself needs nvcc and runs on the GPU machine.
    path = build.library_path(kp.KERNEL)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("pairs-") and path.suffix == ".so"
    assert kp.KERNEL in build.all_sources()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.all_sources()}
    with open(csrc / "pairs.cu", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in build.all_sources()}
    assert after.pop(kp.KERNEL) != before.pop(kp.KERNEL)
    assert after == before


def test_wrappers_refuse_cpu_tensors():
    prep, gx, _ = _prep("random", GlobalSortOrder.Z_DEPTH, (16, 16))
    with pytest.raises(ValueError, match="no pairs kernel"):
        kp.duplicate_with_keys(prep.tiles_touched, prep.rect_min,
                               prep.rect_max, prep.depth, grid_x=gx)
    n = int(prep.tiles_touched.sum())
    keyed = kp.KeyedPairs(torch.zeros(n, dtype=torch.int64),
                          torch.arange(n, dtype=torch.int32),
                          torch.zeros(n, dtype=torch.int32),
                          torch.zeros(prep.tiles_touched.shape[0] + 1,
                                      dtype=torch.int64))
    with pytest.raises(ValueError, match="no pairs kernel"):
        kp.sort_and_identify(keyed, prep.depth, num_tiles=4)


def _span_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("order", KERNEL_ORDERS, ids=lambda o: o.name)
@pytest.mark.parametrize("tile", BINS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_dispatch_hands_the_kernels_the_call(monkeypatch, order, tile):
    # Stand in for a CUDA device: the rule says yes, and the wrappers take
    # the arguments the dispatch passes them and return the torch path's
    # stream and fields, which the dispatch assembles into its buffer.
    prep, gx, gy = _prep("sparse", order, tile)
    want = _torch_path(prep, gx, gy)
    keyed = kp.KeyedPairs(torch.zeros(want.num_rendered, dtype=torch.int64),
                          torch.arange(want.num_rendered, dtype=torch.int32),
                          want.gauss_id.clone(), want.gauss_offsets)
    seen = []

    def dup(touched, rect_min, rect_max, depth, *, grid_x):
        seen.append(("duplicate", grid_x))
        assert all(a is b for a, b in zip(
            (touched, rect_min, rect_max, depth),
            (prep.tiles_touched, prep.rect_min, prep.rect_max, prep.depth)))
        return keyed

    def sort(got_keyed, depth, *, num_tiles):
        seen.append(("sort", num_tiles))
        assert got_keyed is keyed and depth is prep.depth
        return (want.tile_id, want.depth, want.gauss_id, want.starts,
                want.ends, want.orig_slot)

    rule = []
    monkeypatch.setattr(duplicate, "takes_kernel",
                        lambda *a: rule.append(a) or True)
    monkeypatch.setattr(duplicate, "duplicate_with_keys", dup)
    monkeypatch.setattr(duplicate, "sort_and_identify", sort)
    got, names = _span_names(lambda: build_pairs(
        prep, grid_x=gx, grid_y=gy, sort_order=order, tile_x=tile[0],
        tile_y=tile[1]))
    assert rule == [(prep.tiles_touched.device, order, False)]
    assert seen == [("duplicate", gx), ("sort", gx * gy)]
    assert {"stp/duplicate", "stp/sort"} <= names
    assert_same_buffer(got, want)


@pytest.mark.card
@pytest.mark.parametrize("order", KERNEL_ORDERS, ids=lambda o: o.name)
@pytest.mark.parametrize("tile", BINS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_kernels_equal_the_torch_path_on_the_card(card, order, tile):
    """On the card the kernels' buffer is the torch path's, bit for bit,
    with one launch of each wrapper, on each scene (signed zero depths
    keep their signs and tie)."""
    for scene in ("random", "sparse", "empty", "zeros"):
        prep, gx, gy = _prep(scene, order, tile, device="cuda")
        launches = (kp.duplicate_with_keys.launches,
                    kp.sort_and_identify.launches)
        got = build_pairs(prep, grid_x=gx, grid_y=gy, sort_order=order)
        assert (kp.duplicate_with_keys.launches,
                kp.sort_and_identify.launches) == (launches[0] + 1,
                                                   launches[1] + 1)
        want = _torch_path(prep, gx, gy)
        assert_same_buffer(got, want)
        if scene == "empty":
            assert want.num_rendered == 0
        if scene == "zeros":
            signs = torch.signbit(got.depth) & (got.depth == 0)
            assert bool(signs.any()) and bool(((got.depth == 0) & ~signs).any())
