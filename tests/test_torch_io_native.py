"""The port's native capture IO (io/images.py, io/ply.py over native/*.cpp).

- ``read_png`` (the native codec) equals the JAX package's reader and the
  port's plain version ``_read_png_python`` to the bit: every filter type
  and mixed rows at 1-4 channels, odd widths, an IDAT split over several
  chunks, ancillary chunks before it, a Pillow-written file; 16-bit,
  interlaced and palette files raise ValueError as JAX's do, a truncated
  IDAT raises IOError; the port's writer is read back by JAX's reader;
  ``read_png_batch`` equals reading the frames one by one.
- PLY both ways between the packages, to the bit, at 1, 8 and more threads
  than vertices, against ``_read_ply_numpy`` too; a 50K-Gaussian SH-3
  model against JAX's ``load_gaussian_model``.
- The build: each library lands under ``build/torch_native/`` named by the
  hash of its source and flags, nothing is written beside the sources or
  under the repository's ``native/``; a failing compile raises, and the
  readers do not fall back to the plain versions.
"""

import hashlib
import struct
import subprocess
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from stopthepop_tpu.io import images as jimages
from stopthepop_tpu.io import ply as jply
from stopthepop_tpu.models.gaussians import init_random
from stopthepop_tpu_torch.io import images, ply
from stopthepop_tpu_torch.kernels import build
from stopthepop_tpu_torch.models.gaussians import to_numpy_params
from stopthepop_tpu_torch.utils.testing import (
    filtered_png,
    one_thread_under_xdist,
    png_chunk,
)

one_thread_under_xdist()

ROOT = Path(__file__).resolve().parents[1]
# Paeth the most common, as libpng's adaptive filters pick them.
MIXED = [4, 4, 1, 4, 2, 4, 3, 0]


def _img(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _write(path, data: bytes) -> str:
    path.write_bytes(data)
    return str(path)


def _assert_all_read(path, img):
    np.testing.assert_array_equal(images.read_png(path), img)
    np.testing.assert_array_equal(jimages.read_png(path), img)
    np.testing.assert_array_equal(images._read_png_python(path), img)


def _chunks(data: bytes):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], MIXED],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png_every_filter_matches_jax_and_plain(tmp_path, filters, channels):
    img = _img(13, 11, channels, seed=10 * channels + len(filters) + filters[0])
    _assert_all_read(_write(tmp_path / "f.png", filtered_png(img, filters)), img)


@pytest.mark.parametrize("width", [1, 3, 7])
def test_read_png_odd_widths(tmp_path, width):
    for c in (1, 2, 3, 4):
        img = _img(9, width, c, seed=width + c)
        _assert_all_read(_write(tmp_path / f"w{c}.png", filtered_png(img, MIXED)), img)


@pytest.mark.parametrize("layout", ["split_idat", "ancillary_first"])
def test_read_png_chunk_layouts(tmp_path, layout):
    img = _img(17, 12, 3, seed=5)
    data = filtered_png(img, MIXED)
    (ihdr, _), (_, idat), _ = _chunks(data)
    assert ihdr == b"IHDR"
    if layout == "split_idat":
        cuts = [0, 1, len(idat) // 3, len(idat) // 2, len(idat)]
        body = b"".join(png_chunk(b"IDAT", idat[a:b]) for a, b in zip(cuts, cuts[1:]))
    else:
        body = (png_chunk(b"gAMA", struct.pack(">I", 45455))
                + png_chunk(b"tEXt", b"Software\x00stopthepop")
                + png_chunk(b"pHYs", struct.pack(">IIB", 2835, 2835, 1))
                + png_chunk(b"IDAT", idat))
    head = data[:8 + 12 + 13]  # the signature and IHDR
    _assert_all_read(_write(tmp_path / "c.png", head + body + png_chunk(b"IEND", b"")), img)


def test_read_png_pillow_file(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:64, 0:80]
    img = np.stack([x * 3, y * 4, (x + y) * 2, 200 + 0 * x], axis=-1)
    img = (img + rng.integers(0, 9, img.shape)).astype(np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img, "RGBA").save(path)
    with open(path, "rb") as f:
        raw = zlib.decompress(b"".join(p for t, p in _chunks(f.read()) if t == b"IDAT"))
    filters = set(raw[::80 * 4 + 1])
    assert filters - {0}, "Pillow wrote no filtered rows"
    _assert_all_read(path, img)


def _unsupported(depth, color, interlace) -> bytes:
    ihdr = struct.pack(">IIBBBBB", 2, 2, depth, color, 0, 0, interlace)
    raw = zlib.compress(bytes(2 * (1 + 2 * 3 * 2)))
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", raw) + png_chunk(b"IEND", b""))


@pytest.mark.parametrize("header", [(16, 2, 0), (8, 2, 1), (8, 3, 0)],
                         ids=["16bit", "interlaced", "palette"])
def test_unsupported_png_raises_value_error(tmp_path, header):
    path = _write(tmp_path / "u.png", _unsupported(*header))
    with pytest.raises(ValueError, match="unsupported PNG"):
        images.read_png(path)
    with pytest.raises(ValueError):
        jimages.read_png(path)


def test_truncated_idat_raises_ioerror(tmp_path):
    img = _img(20, 20, 3, seed=9)
    (_, ihdr), (_, idat), _ = _chunks(filtered_png(img, MIXED))
    data = (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", idat[: len(idat) // 2]) + png_chunk(b"IEND", b""))
    with pytest.raises(IOError, match="decode failed"):
        images.read_png(_write(tmp_path / "t.png", data))


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 1), (7, 3, 2), (9, 4, 3), (5, 8, 4)])
def test_write_png_read_by_jax(tmp_path, shape):
    img = np.random.default_rng(len(shape) + shape[-1]).integers(
        0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    images.write_png(path, img)
    want = img.reshape(shape[0], shape[1], -1)
    np.testing.assert_array_equal(jimages.read_png(path), want)
    np.testing.assert_array_equal(images._read_png_python(path), want)
    images._write_png_python(str(tmp_path / "p.png"), want)
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "p.png")), want)


def test_read_png_batch_equals_one_by_one(tmp_path):
    paths = []
    for i in range(6):
        img = _img(15 + i, 9, 1 + i % 4, seed=i)
        paths.append(_write(tmp_path / f"b{i}.png", filtered_png(img, MIXED)))
    batch = images.read_png_batch(paths, n_threads=4)
    assert len(batch) == len(paths)
    for got, p in zip(batch, paths):
        np.testing.assert_array_equal(got, images.read_png(p))


def _props(n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(n).astype(np.float32)
            for k in ("x", "y", "z", "opacity", "f_rest_0", "rot_3")}


# More threads than vertices too (the reader takes at most 64 threads).
@pytest.mark.parametrize("n_verts, n_threads", [(1000, 1), (1000, 8), (5, 16)])
def test_ply_interchange_with_jax(tmp_path, n_verts, n_threads):
    props = _props(n_verts, n_threads)
    port, jx = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.write_ply(port, props)
    jply.write_ply(jx, props)
    assert Path(port).read_bytes() == Path(jx).read_bytes()
    for path in (port, jx):
        got = ply.read_ply(path, n_threads=n_threads)
        assert list(got) == list(props)
        for want in (props, jply.read_ply(path), ply._read_ply_numpy(path)):
            for k in props:
                np.testing.assert_array_equal(got[k], want[k])


def test_ply_rejects_other_formats(tmp_path):
    path = tmp_path / "a.ply"
    path.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                     b"property float x\nend_header\n1.0\n")
    with pytest.raises(ValueError):
        ply.read_ply(str(path))
    with pytest.raises(IOError):
        ply.read_ply(str(tmp_path / "missing.ply"))


def test_gaussian_model_50k_against_jax(tmp_path):
    jmodel = init_random(jax.random.PRNGKey(1), 50_000, sh_degree=3)
    path = str(tmp_path / "big.ply")
    jply.save_gaussian_model(path, jmodel)
    assert len(ply.read_ply(path)) == 62
    model = ply.load_gaussian_model(path, device="cpu", n_threads=8)
    want = jply.load_gaussian_model(path)
    got = to_numpy_params(model)
    for k in ("means3d", "scales_log", "rotations", "opacity_logit", "sh_dc", "sh_rest"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)))
    ply.save_gaussian_model(str(tmp_path / "port.ply"), model)
    assert (tmp_path / "port.ply").read_bytes() == Path(path).read_bytes()


SOURCES = ROOT / "stopthepop_tpu_torch" / "native"


def _expected_name(name):
    h = hashlib.sha256((SOURCES / f"{name}.cpp").read_bytes())
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    flags += {"png_io": ["-lz"], "ply_io": ["-pthread"]}[name]
    h.update(" ".join(flags).encode())
    return f"{name}-{h.hexdigest()[:16]}.so"


def test_host_libraries_build_under_build_dir(tmp_path, monkeypatch):
    for name in ("png_io", "ply_io"):
        assert build.host_library_path(name) == (
            ROOT / "build" / "torch_native" / _expected_name(name))
    # A fresh build, every compiler call recorded.
    out_dir = tmp_path / "torch_native"
    monkeypatch.setattr(build, "HOST_BUILD_DIR", out_dir)
    calls = []
    real_popen = subprocess.Popen

    def popen(cmd, *a, **kw):
        calls.append(cmd)
        return real_popen(cmd, *a, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", popen)
    build.build_host(["png_io", "ply_io"])
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        _expected_name(n) for n in ("png_io", "ply_io"))
    assert len(calls) == 2
    for cmd in calls:
        paths = [Path(a) for a in cmd if a.endswith((".cpp", ".so"))]
        assert [p.parent for p in paths] == [out_dir, SOURCES]
    build.build_host(["png_io", "ply_io"])
    assert len(calls) == 2, "a built library was compiled again"
    assert sorted(p.name for p in SOURCES.iterdir()) == ["ply_io.cpp", "png_io.cpp"]
    assert not any((ROOT / "native" / _expected_name(n)).exists() for n in ("png_io", "ply_io"))


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "png_io.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "NATIVE", src)
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed for png_io.cpp"):
        build.build_host(["png_io"])
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").glob("*.so"))
    path = tmp_path / "a.png"
    images._write_png_python(str(path), _img(4, 4, 3, seed=0))
    images._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            images.read_png(str(path))
    finally:
        images._native.cache_clear()
