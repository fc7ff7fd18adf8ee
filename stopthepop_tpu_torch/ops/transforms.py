"""Camera / projection transforms on torch tensors.

Port of ``stopthepop_tpu/ops/transforms.py``. Matrix convention matches the
reference / torch-3DGS: ``viewmatrix`` and ``projmatrix`` are the transposed
world-to-view / world-to-clip matrices, so a point transforms as
``p_out = [p, 1] @ M`` (reference: auxiliary.h:130-149).

The K=3 contractions are written out component by component: full float32
whatever ``torch.backends.cuda.matmul.allow_tf32`` says, as the JAX package
forces ``Precision.HIGHEST`` for the same reason (a TF32/bf16 rounding
jitters projected positions by ~0.1 px).
"""

from __future__ import annotations

import torch

from ..constants import NDC_W_EPS, NEAR_Z


def _affine(p, m, cols):
    return (p[..., 0:1] * m[0, cols] + p[..., 1:2] * m[1, cols]
            + p[..., 2:3] * m[2, cols] + m[3, cols])


def transform_point_4x3(p, m):
    """p [..., 3], m [4, 4] -> view-space point [..., 3]. auxiliary.h:130-138."""
    return _affine(p, m, slice(0, 3))


def transform_point_4x4(p, m):
    """p [..., 3], m [4, 4] -> homogeneous [..., 4]. auxiliary.h:140-149."""
    return _affine(p, m, slice(0, 4))


def world2ndc(p_world, viewproj):
    """NDC coordinates with the reference's w-epsilon. auxiliary.h:83-90."""
    p_hom = transform_point_4x4(p_world, viewproj)
    rcp_w = 1.0 / (p_hom[..., 3:4] + NDC_W_EPS)
    return p_hom[..., :3] * rcp_w


def ndc2pix(v, size):
    """NDC [-1, 1] to continuous pixel coordinate. auxiliary.h:66-69."""
    return ((v + 1.0) * size - 1.0) * 0.5


def pix2world(pix, w, h, inverse_vp):
    """Pixel coordinate [..., 2] to the world-space point on the camera plane.

    Reference: auxiliary.h:71-81 (uses rows 0, 1, 3 of the torch-layout
    inverse view-projection matrix). The pixel coordinate is taken as given
    (integer pixels, no +0.5), as in the JAX package.
    """
    ndc_x = pix[..., 0] * (2.0 / w) - 1.0
    ndc_y = pix[..., 1] * (2.0 / h) - 1.0
    p = (ndc_x[..., None] * inverse_vp[0] + ndc_y[..., None] * inverse_vp[1]
         + inverse_vp[3])
    return p[..., :3] / p[..., 3:4]


def compute_view_ray(pix, w, h, inverse_vp, campos):
    """Normalized world-space ray direction through a pixel [..., 3].

    Reference: stopthepop_common.cuh:68-74 (computeViewRay). The norm is
    written out, ((x^2 + y^2) + z^2), as the k-buffer kernels compute it.
    """
    d = pix2world(pix, w, h, inverse_vp) - campos
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return d / norm[..., None]


def in_frustum(means3d, viewmatrix):
    """Near-plane visibility plus view-space position.

    Reference: auxiliary.h:211-236 (only z > 0.2 is tested; the lateral NDC
    test is commented out upstream). Returns (visible [P] bool, p_view [P, 3]).
    """
    p_view = transform_point_4x3(means3d, viewmatrix)
    return p_view[..., 2] > NEAR_Z, p_view


def mark_visible(positions, viewmatrix, projmatrix):
    """Standalone frustum marking, reference rasterizer_impl.cu:161-173."""
    del projmatrix  # matches reference: only the view matrix is used
    visible, _ = in_frustum(positions, viewmatrix)
    return visible

