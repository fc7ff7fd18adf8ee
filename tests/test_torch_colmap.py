"""The port's COLMAP IO (io/colmap.py), ``read_image``, the COLMAP dataset
loader and both CLIs on a COLMAP capture, against the JAX package, on the
CPU.

- binary files written by one package's writers and read by the other's
  readers give equal structures, exactly, both ways; so do text files;
- ``load_colmap`` gives cameras whose matrices are within 1e-6 of JAX's;
- ``load_colmap_dataset`` gives equal targets (exactly), equal splits and
  the same extent (1e-6);
- ``qvec2rotmat`` is orthonormal and ``rotmat2qvec`` its inverse;
- train/cli.py trains two iterations on a written capture from its
  points, and render/cli.py renders its views;
- ``read_image`` on a PNG equals ``read_png``, on a JPEG JAX's.
"""

import math

import numpy as np
import pytest

from stopthepop_tpu.io import colmap as jcolmap
from stopthepop_tpu.io.images import read_image as jax_read_image
from stopthepop_tpu.train import cli as jax_train_cli

from stopthepop_tpu_torch.io import colmap
from stopthepop_tpu_torch.io.images import read_image, read_png, write_png
from stopthepop_tpu_torch.io.ply import load_gaussian_model
from stopthepop_tpu_torch.models.gaussians import from_points
from stopthepop_tpu_torch.render import cli as render_cli
from stopthepop_tpu_torch.train import cli as train_cli
from stopthepop_tpu_torch.utils.synthetic import (
    structured_scene,
    write_colmap_capture,
)
from stopthepop_tpu_torch.utils.testing import one_thread_under_xdist

one_thread_under_xdist()


def _structures(mod, n_points=40):
    """Cameras of several models, two images, a point cloud."""
    cams = {
        1: mod.ColmapCamera(1, "PINHOLE", 64, 48,
                            np.array([50.0, 51.0, 32.0, 24.0])),
        2: mod.ColmapCamera(2, "SIMPLE_RADIAL", 80, 60,
                            np.array([70.0, 40.0, 30.0, 0.01])),
        3: mod.ColmapCamera(3, "OPENCV", 32, 32,
                            np.arange(8, dtype=np.float64) + 10.0),
    }
    images = [
        mod.ColmapImage(7, np.array([1.0, 0.0, 0.0, 0.0]),
                        np.array([0.0, 0.0, 0.0]), 1, "b.png"),
        mod.ColmapImage(3, np.array([math.cos(0.2), 0.0, math.sin(0.2), 0.0]),
                        np.array([0.1, -0.2, 0.3]), 2, "a.jpg"),
    ]
    rng = np.random.default_rng(0)
    pts = mod.ColmapPoints(
        xyz=rng.uniform(-1, 1, (n_points, 3)).astype(np.float32),
        # Colours on the u8 grid, so they survive the writers' quantization.
        rgb=(rng.integers(0, 256, (n_points, 3)) / 255.0).astype(np.float32),
        error=rng.uniform(0, 2, n_points).astype(np.float32),
    )
    return cams, images, pts


def _write_binary(mod, sparse, cams, images, pts):
    sparse.mkdir(parents=True, exist_ok=True)
    mod.write_cameras_binary(str(sparse / "cameras.bin"), cams)
    mod.write_images_binary(str(sparse / "images.bin"), images)
    mod.write_points3d_binary(str(sparse / "points3D.bin"), pts)


def _read(mod, sparse, kind):
    ext = {"binary": "bin", "text": "txt"}[kind]
    return tuple(getattr(mod, f"read_{what.lower()}_{kind}")(
        str(sparse / f"{what}.{ext}")) for what in ("cameras", "images",
                                                    "points3D"))


def _assert_equal(got, ref):
    cams, images, pts = got
    rcams, rimages, rpts = ref
    assert sorted(cams) == sorted(rcams)
    for k in cams:
        a, b = cams[k], rcams[k]
        assert (a.camera_id, a.model, a.width, a.height) == (
            b.camera_id, b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    assert len(images) == len(rimages)
    for a, b in zip(images, rimages):
        assert (a.image_id, a.camera_id, a.name) == (b.image_id, b.camera_id,
                                                     b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    for f in ("xyz", "rgb", "error"):
        a, b = getattr(pts, f), getattr(rpts, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_files_read_equal_both_ways(writer, tmp_path):
    wmod, rmod = (jcolmap, colmap) if writer == "jax" else (colmap, jcolmap)
    _write_binary(wmod, tmp_path, *_structures(wmod))
    got = _read(rmod, tmp_path, "binary")
    _assert_equal(got, _read(wmod, tmp_path, "binary"))
    _assert_equal(got, _structures(colmap))


def test_text_files_read_equal(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 64 48 50 51 32 24\n"
        "2 SIMPLE_RADIAL 80 60 70 40 30 0.01\n")
    (tmp_path / "images.txt").write_text(
        "# Image list\n"
        "7 1 0 0 0 0 0 0 1 b.png\n10.5 3.5 -1\n"
        f"3 {math.cos(0.2)!r} 0 {math.sin(0.2)!r} 0 0.1 -0.2 0.3 2 a.jpg\n"
        "1.5 2.5 4\n")
    (tmp_path / "points3D.txt").write_text(
        "# 3D points\n1 0.5 -0.25 2 255 128 0 0.75 1 2\n"
        "9 -1 1 0.125 3 4 5 0.5\n")
    got = _read(colmap, tmp_path, "text")
    _assert_equal(got, _read(jcolmap, tmp_path, "text"))
    assert got[1][1].name == "a.jpg" and got[2].xyz.shape == (2, 3)


def _capture(root, views=10, width=40, height=30, points=150):
    model, _ = structured_scene(600, seed=1, device="cpu")
    write_colmap_capture(str(root), model, views=views, width=width,
                         height=height, points=points, device="cpu")
    return model


def test_load_colmap_and_dataset_match_jax(tmp_path):
    _capture(tmp_path)
    cams, pts = colmap.load_colmap(str(tmp_path))
    jcams, jpts = jcolmap.load_colmap(str(tmp_path))
    assert [c.image_path for c in cams] == [c.image_path for c in jcams]
    for c, j in zip(cams, jcams):
        for f in ("viewmatrix", "projmatrix", "inv_viewprojmatrix", "campos"):
            np.testing.assert_allclose(getattr(c, f), getattr(j, f), rtol=0,
                                       atol=1e-6, err_msg=f)
        assert (c.width, c.height) == (j.width, j.height) == (40, 30)
        assert abs(c.tanfovx - j.tanfovx) < 1e-6
    for f in ("xyz", "rgb", "error"):
        np.testing.assert_array_equal(getattr(pts, f), getattr(jpts, f))

    bg = np.zeros(3, np.float32)
    for split in ("train", "test"):
        c, t, p, e = train_cli.load_colmap_dataset(str(tmp_path), split, 1, bg)
        jc, jt, jp, je = jax_train_cli.load_colmap_dataset(str(tmp_path),
                                                            split, 1, bg)
        assert [x.image_path for x in c] == [x.image_path for x in jc]
        np.testing.assert_array_equal(t, jt)
        assert abs(e - je) < 1e-6 and e > 0
        assert len(c) == (2 if split == "test" else 8)  # llffhold 8 of 10
    # An image taken from the capture's own orbit renders, as written.
    np.testing.assert_array_equal(
        t[0], read_png(c[0].image_path).transpose(2, 0, 1) / np.float32(255.0))


def test_qvec2rotmat_is_orthonormal_and_rotmat2qvec_inverts_it():
    rng = np.random.default_rng(3)
    for q in rng.standard_normal((20, 4)):
        q = q / np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert abs(np.linalg.det(R) - 1.0) < 1e-12
        np.testing.assert_allclose(R, jcolmap.qvec2rotmat(q), rtol=0, atol=0)
        q2 = colmap.rotmat2qvec(R)
        np.testing.assert_allclose(q2, q if q[0] >= 0 else -q, atol=1e-12)


def test_train_and_render_clis_on_a_colmap_capture(tmp_path):
    data = tmp_path / "capture"
    _capture(data)
    _, pts = colmap.load_colmap(str(data))
    out = tmp_path / "m.ply"
    res = train_cli.main(["--data", str(data), "--iters", "2",
                          "--eval-every", "1", "--sh-degree", "1",
                          "--out", str(out), "--device", "cpu"])
    assert res.state.step == 2 and sorted(res.eval_psnr) == [1, 2]
    assert all(np.isfinite(v) for v in res.eval_psnr.values())
    start = from_points(pts.xyz, pts.rgb, sh_degree=1, device="cpu")
    assert res.state.model.num_gaussians == pts.xyz.shape[0]
    # Two small steps move the means by a few 1e-4 at most: the model
    # started from the capture's points.
    moved = (res.state.model.means3d.detach() - start.means3d.detach()).abs()
    assert 0 < float(moved.max()) < 1e-2
    assert load_gaussian_model(str(out), "cpu").num_gaussians == 150

    frames = tmp_path / "frames"
    render_cli.main(["--ply", str(out), "--data", str(data), "--frames", "3",
                     "--out", str(frames), "--sort-mode", "PPX_KBUFFER",
                     "--device", "cpu"])
    imgs = [read_png(str(frames / f"frame_{i:04d}.png")) for i in range(3)]
    assert all(im.shape == (30, 40, 3) for im in imgs)
    assert any(im.max() > 0 for im in imgs)


def test_read_image_png_and_jpeg(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (12, 17, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.png")),
                                  read_png(str(tmp_path / "a.png")))
    from PIL import Image

    Image.fromarray(img).save(tmp_path / "b.jpg", quality=90)
    got = read_image(str(tmp_path / "b.jpg"))
    assert got.dtype == np.uint8 and got.shape == (12, 17, 3)
    np.testing.assert_array_equal(got, jax_read_image(str(tmp_path / "b.jpg")))
    Image.fromarray(img[:, :, 0]).save(tmp_path / "g.jpg")
    assert read_image(str(tmp_path / "g.jpg")).shape == (12, 17, 1)
