"""The port's math ops and settings against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
port runs on CPU tensors. Tolerance: rtol = atol = 1e-5 (float32 math in a
different operation order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu.config as jcfg
import stopthepop_tpu.constants as jconst
from stopthepop_tpu.ops import covariance as jcov
from stopthepop_tpu.ops import sh as jsh
from stopthepop_tpu.ops import sort as jsort
from stopthepop_tpu.ops import stopthepop as jstp
from stopthepop_tpu.ops import transforms as jtr
from stopthepop_tpu.utils.testing import make_camera as jax_make_camera

import stopthepop_tpu_torch.config as tcfg
import stopthepop_tpu_torch.constants as tconst
from stopthepop_tpu_torch.ops import covariance as tcov
from stopthepop_tpu_torch.ops import sh as tsh
from stopthepop_tpu_torch.ops import sort as tsort
from stopthepop_tpu_torch.ops import stopthepop as tstp
from stopthepop_tpu_torch.ops import transforms as ttr
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
)

one_thread_under_xdist()

TOL = dict(rtol=1e-5, atol=1e-5)
P = 200


def _close(t, j, **kw):
    np.testing.assert_allclose(
        t.detach().cpu().numpy(), np.asarray(j), **(kw or TOL)
    )


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, 4)).astype(np.float32)
    return {
        "means": rng.uniform(-1.5, 1.5, (P, 3)).astype(np.float32),
        "scales": np.exp(rng.uniform(np.log(0.01), np.log(0.12), (P, 3))).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "opac": rng.uniform(0.2, 0.95, (P,)).astype(np.float32),
        "shs": (0.3 * rng.standard_normal((P, 16, 3))).astype(np.float32),
    }


def _cam(w=64, h=48):
    cam = make_camera(w, h, campos=(0.3, -0.2, -4.0), device="cpu")
    jcam = jax_make_camera(w, h, campos=(0.3, -0.2, -4.0))
    return cam, jcam


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_settings_json_round_trip_matches():
    ext = tcfg.ExtendedSettings()
    for key, value in (("sort_mode", 3), ("sort_order", 1), ("tile_4x4", 32),
                       ("rect_bounding", True), ("proper_ewa_scaling", True)):
        ext.set_value(key, value)
    jext = jcfg.ExtendedSettings.from_dict(ext.to_dict())
    assert jext.to_dict() == ext.to_dict()
    assert tcfg.ExtendedSettings.from_dict(jext.to_dict()).to_json() == ext.to_json()
    assert [f.name for f in dataclasses.fields(tcfg.ExtendedSettings)] == [
        f.name for f in dataclasses.fields(jcfg.ExtendedSettings)
    ]
    assert tcfg.GaussianRasterizationSettings._fields == jcfg.GaussianRasterizationSettings._fields


def test_make_camera_matches_jax():
    cam, jcam = _cam()
    for f in ("viewmatrix", "projmatrix", "inv_viewprojmatrix", "campos"):
        _close(getattr(cam, f), getattr(jcam, f), rtol=0, atol=0)
    assert (cam.tanfovx, cam.tanfovy) == (jcam.tanfovx, jcam.tanfovy)


def test_transforms_match_jax():
    x = _inputs()
    cam, jcam = _cam()
    m = torch.from_numpy(x["means"])
    jm = jnp.asarray(x["means"])
    _close(ttr.transform_point_4x3(m, cam.viewmatrix),
           jtr.transform_point_4x3(jm, jcam.viewmatrix))
    _close(ttr.transform_point_4x4(m, cam.projmatrix),
           jtr.transform_point_4x4(jm, jcam.projmatrix))
    _close(ttr.world2ndc(m, cam.projmatrix), jtr.world2ndc(jm, jcam.projmatrix))
    v = torch.linspace(-1.2, 1.2, 11)
    _close(ttr.ndc2pix(v, 64), jtr.ndc2pix(jnp.asarray(v.numpy()), 64))
    vis, pv = ttr.in_frustum(m, cam.viewmatrix)
    jvis, jpv = jtr.in_frustum(jm, jcam.viewmatrix)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    _close(pv, jpv)
    np.testing.assert_array_equal(
        ttr.mark_visible(m, cam.viewmatrix, cam.projmatrix).numpy(),
        np.asarray(jtr.mark_visible(jm, jcam.viewmatrix, jcam.projmatrix)),
    )


def test_covariance_matches_jax():
    x = _inputs(1)
    q, s = torch.from_numpy(x["quats"]), torch.from_numpy(x["scales"])
    jq, js = jnp.asarray(x["quats"]), jnp.asarray(x["scales"])
    _close(tcov.quat_to_rotmat(q), jcov.quat_to_rotmat(jq))
    cov3d = tcov.compute_cov3d(s, 1.3, q)
    jcov3d = jcov.compute_cov3d(js, 1.3, jq)
    _close(cov3d, jcov3d)
    _close(tcov.unpack_sym3(cov3d), jcov.unpack_sym3(jcov3d))
    _close(tcov.compute_inv_cov3d(s, 0.9, q), jcov.compute_inv_cov3d(js, 0.9, jq),
           rtol=1e-5, atol=1e-3)  # entries reach ~1e4
    cam, jcam = _cam()
    _, pv = ttr.in_frustum(torch.from_numpy(x["means"]), cam.viewmatrix)
    _, jpv = jtr.in_frustum(jnp.asarray(x["means"]), jcam.viewmatrix)
    c2 = tcov.compute_cov2d(pv, 55.4, 41.6, cam.tanfovx, cam.tanfovy, cov3d,
                            cam.viewmatrix)
    jc2 = jcov.compute_cov2d(jpv, 55.4, 41.6, jcam.tanfovx, jcam.tanfovy,
                             jcov3d, jcam.viewmatrix)
    _close(c2, jc2)
    for ewa in (False, True):
        d, det, f = tcov.dilate_cov2d(c2, ewa)
        jd, jdet, jf = jcov.dilate_cov2d(jc2, ewa)
        _close(d, jd)
        _close(det, jdet)
        _close(f, jf)
        o = torch.from_numpy(x["opac"])
        _close(tcov.conic_opacity(d, o, det, f),
               jcov.conic_opacity(jd, jnp.asarray(x["opac"]), jdet, jf))


def test_fov_clamp_in_cov2d_matches_jax():
    # View positions far outside the frustum exercise the 1.3 tan-fov clamp.
    rng = np.random.default_rng(5)
    pv = np.stack([rng.uniform(-20, 20, P), rng.uniform(-20, 20, P),
                   rng.uniform(0.5, 3.0, P)], axis=1).astype(np.float32)
    cov3d = np.abs(rng.standard_normal((P, 6))).astype(np.float32) * 0.01
    vm = np.eye(4, dtype=np.float32)
    out = tcov.compute_cov2d(torch.from_numpy(pv), 50.0, 40.0, 0.5, 0.4,
                             torch.from_numpy(cov3d), torch.from_numpy(vm))
    jout = jcov.compute_cov2d(jnp.asarray(pv), 50.0, 40.0, 0.5, 0.4,
                              jnp.asarray(cov3d), jnp.asarray(vm))
    _close(out, jout)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    x = _inputs(2)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    rgb, clamped = tsh.eval_sh(torch.from_numpy(x["shs"]), torch.from_numpy(x["means"]),
                               torch.from_numpy(campos), degree)
    jrgb, jclamped = jsh.eval_sh(jnp.asarray(x["shs"]), jnp.asarray(x["means"]),
                                 jnp.asarray(campos), degree)
    _close(rgb, jrgb)
    assert (rgb >= 0).all()
    np.testing.assert_array_equal(clamped.numpy(), np.asarray(jclamped))


def test_pack_inv_cov3d_matches_jax():
    x = _inputs(3)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    out = tstp.pack_inv_cov3d(torch.from_numpy(x["scales"]), 1.0,
                              torch.from_numpy(x["quats"]),
                              torch.from_numpy(x["means"]), torch.from_numpy(campos))
    jout = jstp.pack_inv_cov3d(jnp.asarray(x["scales"]), 1.0, jnp.asarray(x["quats"]),
                               jnp.asarray(x["means"]), jnp.asarray(campos))
    _close(out, jout, rtol=1e-5, atol=1e-2)  # u entries reach ~1e5


def test_sort_pairs_and_ranges_match_jax():
    rng = np.random.default_rng(4)
    n, tiles = 500, 12
    tid = rng.integers(0, tiles, n).astype(np.int32)
    depth = rng.uniform(0.3, 5.0, n).astype(np.float32)
    depth[::7] = depth[0]  # exact ties resolve by input order on both sides
    val = np.arange(n, dtype=np.int32)
    out = tsort.sort_pairs(torch.from_numpy(tid), torch.from_numpy(depth),
                           torch.from_numpy(val))
    jout = jsort.sort_pairs(jnp.asarray(tid), jnp.asarray(depth), jnp.asarray(val))
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s, e = tsort.identify_tile_ranges(out[0], tiles)
    js, je = jsort.identify_tile_ranges(jout[0], tiles)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
