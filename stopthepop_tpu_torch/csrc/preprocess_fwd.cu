// Per-Gaussian preprocess, forward (kernel K8 of the port).
//
// Replaces no Pallas kernel: the JAX package computes the preprocess in jnp
// (stopthepop_tpu/render/preprocess.py) for XLA to fuse, and the port's
// plain PyTorch version (render/preprocess.py with ops/transforms.py,
// covariance.py, sh.py and stopthepop.py) runs as ~470 small launches over
// every Gaussian. This kernel computes every field of PreprocessOutput in
// one launch, one thread a Gaussian, as the reference's preprocessCUDA
// (forward.cu:68-229) does. render/preprocess.py::preprocess launches it
// only where no gradient is wanted and no covariance is precomputed; the
// plain version stays the path of training and of the CPU.
//
// Each field has the plain version's value, culled rows included (their
// view position is (0, 0, 1), radii and tiles_touched 0): the operations
// come in the plain version's order, each product and sum rounds on its
// own (-fmad=false), sqrtf, logf, floorf, ceilf and the divisions are the
// accurate ones, a division by a Python number is a product with its
// reciprocal, taken in double and rounded to float (what PyTorch does with
// a CPU scalar divisor), and the clamps propagate NaN as PyTorch's do. The one reduction of the plain
// version, torch.linalg.norm over (mean - campos) in the SH direction and
// the DISTANCE depth, sums its squares as (x^2 + z^2) + y^2, the order in
// which PyTorch's reduction splits three inputs over two lanes.
//
// What bounds it on an H100: bytes. It reads each Gaussian's mean (12 B),
// opacity (4 B), scales (12 B), rotation (16 B) and its SH coefficients
// ((degree + 1)^2 x 12 B: 192 B at degree 3), and writes the 15 fields,
// 132 B: 368 B a Gaussian at degree 3, against a few hundred float
// operations: 2.245 GB a frame of the 6.1M-Gaussian bicycle configuration,
// 0.670 ms at 3.35 TB/s; K8 takes 0.77 ms there, 87% of it (PERF.md). Its
// design against that bound:
//
//   * blocks of 128 threads; a block's SH rows are copied into shared
//     memory with cp.async, 4 B a lane in the order they lie in device
//     memory (coalesced for any row length and alignment), while each
//     thread computes its Gaussian's geometry; rows are padded to an odd
//     stride, so that each thread reading its own row hits its own bank;
//   * every output is written once: the 8- and 16-byte rows as vector
//     stores and the 4- and 1-byte fields straight from each thread; the
//     rows of 12 B (p_view, rgb), 36 B (cov3d_inv9) and 3 B (clamped) are
//     staged in shared memory and written by the block as coalesced spans
//     (0.7655 ms against 0.7710 for straight stores, PERF.md; 0.02% of a
//     bicycle frame, which no end-to-end metric can see);
//   * no temporaries: nothing but the outputs is written.
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain C
// interface, loaded with ctypes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
// SH floats a row at most: (3 + 1)^2 coefficients x 3 channels.
constexpr int kMaxShFloats = 48;

// The plain version's constants: each a Python double rounded to float32
// once, as PyTorch rounds a Python number for a float32 tensor.
constexpr float kNearZ = static_cast<float>(0.2);
constexpr float kDilation = static_cast<float>(0.3);
constexpr float kEwaDetFloor = static_cast<float>(0.000025);
constexpr float kAlphaThreshold = static_cast<float>(1.0 / 255.0);
constexpr float kInvAlphaThreshold = static_cast<float>(1.0 / (1.0 / 255.0));
constexpr float kExtentSigma = static_cast<float>(3.33);
constexpr float kMinLambda = static_cast<float>(0.01);
constexpr float kScaleFloor = static_cast<float>(1.0e-3);
constexpr float kNdcWEps = static_cast<float>(1.0e-7);
constexpr float kShC0 = static_cast<float>(0.28209479177387814);
constexpr float kShC1 = static_cast<float>(0.4886025119029199);
constexpr float kShC20 = static_cast<float>(1.0925484305920792);
constexpr float kShC21 = static_cast<float>(-1.0925484305920792);
constexpr float kShC22 = static_cast<float>(0.31539156525252005);
constexpr float kShC23 = static_cast<float>(-1.0925484305920792);
constexpr float kShC24 = static_cast<float>(0.5462742152960396);
constexpr float kShC30 = static_cast<float>(-0.5900435899266435);
constexpr float kShC31 = static_cast<float>(2.890611442640554);
constexpr float kShC32 = static_cast<float>(-0.4570457994644658);
constexpr float kShC33 = static_cast<float>(0.3731763325901154);
constexpr float kShC34 = static_cast<float>(-0.4570457994644658);
constexpr float kShC35 = static_cast<float>(1.445305721320277);
constexpr float kShC36 = static_cast<float>(-0.5900435899266435);

struct Params {
  const float* means3d;         // [P, 3]
  const float* opacities;       // [P]
  const float* scales;          // [P, 3]
  const float* rotations;       // [P, 4] (r, x, y, z)
  const float* shs;             // [P, M, 3], or null
  const float* colors;          // [P, 3] colors_precomp, or null
  const float* viewmatrix;      // [4, 4]
  const float* projmatrix;      // [4, 4]
  const float* campos;          // [3]
  int num_points;
  int sh_floats;                // (degree + 1)^2 x 3 read of each row
  int sh_row;                   // M x 3, the row's stride
  float scale_modifier;
  float focal_x, focal_y;       // W / (2 tan_fovx), H / (2 tan_fovy)
  float lim_x, lim_y;           // 1.3 tan_fovx, 1.3 tan_fovy
  int width, height;
  float inv_tile_x, inv_tile_y;  // 1 / tile, in double, rounded to float
  int grid_x, grid_y;
  bool distance, rect_bounding, tight_opacity, proper_ewa;
  // PreprocessOutput's fields, in its order.
  bool* valid;
  float* p_view;
  float* mean2d;
  float* depth;
  float* conic_opacity;
  float* rgb;
  bool* clamped;
  float* radius;
  int* radii;
  float* rect_dims;
  int* rect_min;
  int* rect_max;
  int* tiles_touched;
  float* cov3d_inv9;
  float* opacity_power_threshold;
};

// PyTorch's clamp, clamp_min, clamp_max and minimum on float32: NaN
// propagates, else CUDA's fminf / fmaxf.
__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// Packed symmetric R diag(d) R^T of an unnormalised quaternion (r, x, y, z):
// ops/covariance.py::_rot_diag_rot_t.
__device__ __forceinline__ void rot_diag_rot_t(float r, float x, float y,
                                               float z, float d0, float d1,
                                               float d2, float out[6]) {
  const float m0 = 1.0f - 2.0f * (y * y + z * z);
  const float m1 = 2.0f * (x * y - r * z);
  const float m2 = 2.0f * (x * z + r * y);
  const float m3 = 2.0f * (x * y + r * z);
  const float m4 = 1.0f - 2.0f * (x * x + z * z);
  const float m5 = 2.0f * (y * z - r * x);
  const float m6 = 2.0f * (x * z - r * y);
  const float m7 = 2.0f * (y * z + r * x);
  const float m8 = 1.0f - 2.0f * (x * x + y * y);
  out[0] = d0 * m0 * m0 + d1 * m1 * m1 + d2 * m2 * m2;
  out[1] = d0 * m0 * m3 + d1 * m1 * m4 + d2 * m2 * m5;
  out[2] = d0 * m0 * m6 + d1 * m1 * m7 + d2 * m2 * m8;
  out[3] = d0 * m3 * m3 + d1 * m4 * m4 + d2 * m5 * m5;
  out[4] = d0 * m3 * m6 + d1 * m4 * m7 + d2 * m5 * m8;
  out[5] = d0 * m6 * m6 + d1 * m7 * m7 + d2 * m8 * m8;
}

__global__ void __launch_bounds__(kBlock)
preprocess_fwd_kernel(const Params p) {
  __shared__ float s_sh[kBlock * (kMaxShFloats + 1)];
  __shared__ float s_mat[35];  // view 4x4, proj 4x4, campos
  // Staged rows: p_view, rgb, cov3d_inv9 and clamped.
  __shared__ float s_pview[kBlock * 3];
  __shared__ float s_rgb[kBlock * 3];
  __shared__ float s_inv9[kBlock * 9];
  __shared__ bool s_clamped[kBlock * 3];

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kBlock), p.num_points - base));
  const bool live = tid < rows;
  const long long i = base + tid;

  if (tid < 16) {
    s_mat[tid] = p.viewmatrix[tid];
  } else if (tid < 32) {
    s_mat[tid] = p.projmatrix[tid - 16];
  } else if (tid < 35) {
    s_mat[tid] = p.campos[tid - 32];
  }

  // The block's SH rows, copied in their memory order: element l of the
  // block's (row, float) span goes to row l / n, float l % n.
  const int n_sh = p.shs != nullptr ? p.sh_floats : 0;
  const int stride = n_sh | 1;
  if (n_sh > 0) {
    const float* src = p.shs + base * p.sh_row;
    const int step_row = kBlock / n_sh, step_col = kBlock % n_sh;
    int row = tid / n_sh, col = tid % n_sh;
    for (int l = tid; l < rows * n_sh; l += kBlock) {
      __pipeline_memcpy_async(&s_sh[row * stride + col],
                              src + static_cast<long long>(row) * p.sh_row + col,
                              sizeof(float));
      row += step_row;
      col += step_col;
      if (col >= n_sh) {
        col -= n_sh;
        ++row;
      }
    }
    __pipeline_commit();
  }
  __syncthreads();
  const float* V = s_mat;
  const float* Pm = s_mat + 16;
  const float* cam = s_mat + 32;

  float v[3] = {0.0f, 0.0f, 0.0f};  // mean - campos
  float view_z = 1.0f;
  if (live) {
    const float mx = p.means3d[3 * i], my = p.means3d[3 * i + 1],
                mz = p.means3d[3 * i + 2];

    // in_frustum: the view position, visible where z > 0.2; culled rows
    // go on with (0, 0, 1).
    float pv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      pv[j] = mx * V[j] + my * V[4 + j] + mz * V[8 + j] + V[12 + j];
    }
    const bool visible = pv[2] > kNearZ;
    if (!visible) {
      pv[0] = 0.0f;
      pv[1] = 0.0f;
      pv[2] = 1.0f;
    }

    // compute_cov3d and compute_inv_cov3d.
    const float r = p.rotations[4 * i], qx = p.rotations[4 * i + 1],
                qy = p.rotations[4 * i + 2], qz = p.rotations[4 * i + 3];
    float s2[3], inv_s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = p.scales[3 * i + k];
      const float sm = s * p.scale_modifier;
      s2[k] = sm * sm;
      const float sf = clamp_min(s, kScaleFloor) * p.scale_modifier;
      inv_s2[k] = 1.0f / (sf * sf);
    }
    float cov[6], inv6[6];
    rot_diag_rot_t(r, qx, qy, qz, s2[0], s2[1], s2[2], cov);
    rot_diag_rot_t(r, qx, qy, qz, inv_s2[0], inv_s2[1], inv_s2[2], inv6);

    // compute_cov2d: the EWA Jacobian at the clamped view position.
    const float tz = pv[2];
    const float tx = clamp_both(pv[0] / tz, -p.lim_x, p.lim_x) * tz;
    const float ty = clamp_both(pv[1] / tz, -p.lim_y, p.lim_y) * tz;
    const float inv_z = 1.0f / tz;
    const float inv_z2 = inv_z * inv_z;
    const float j00 = p.focal_x * inv_z;
    const float j02 = -p.focal_x * tx * inv_z2;
    const float j11 = p.focal_y * inv_z;
    const float j12 = -p.focal_y * ty * inv_z2;
    float t0[3], t1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t0[c] = j00 * V[4 * c] + j02 * V[4 * c + 2];
      t1[c] = j11 * V[4 * c + 1] + j12 * V[4 * c + 2];
    }
    const float s0[3] = {cov[0] * t0[0] + cov[1] * t0[1] + cov[2] * t0[2],
                         cov[1] * t0[0] + cov[3] * t0[1] + cov[4] * t0[2],
                         cov[2] * t0[0] + cov[4] * t0[1] + cov[5] * t0[2]};
    const float c00 = t0[0] * s0[0] + t0[1] * s0[1] + t0[2] * s0[2];
    const float c01 = t1[0] * s0[0] + t1[1] * s0[1] + t1[2] * s0[2];
    const float s1[3] = {cov[0] * t1[0] + cov[1] * t1[1] + cov[2] * t1[2],
                         cov[1] * t1[0] + cov[3] * t1[1] + cov[4] * t1[2],
                         cov[2] * t1[0] + cov[4] * t1[1] + cov[5] * t1[2]};
    const float c11 = t1[0] * s1[0] + t1[1] * s1[1] + t1[2] * s1[2];

    // dilate_cov2d and conic_opacity.
    const float xx = c00 + kDilation, xy = c01, yy = c11 + kDilation;
    const float det = xx * yy - xy * xy;
    float factor = 1.0f;
    if (p.proper_ewa) {
      const float det_orig = c00 * c11 - c01 * c01;
      factor = sqrtf(clamp_min(det_orig / det, kEwaDetFloor));
    }
    bool valid = visible && det != 0.0f;
    const float det_safe = det == 0.0f ? 1.0f : det;
    const float det_inv = 1.0f / det_safe;
    const float opacity = p.opacities[i] * factor;
    reinterpret_cast<float4*>(p.conic_opacity)[i] =
        make_float4(yy * det_inv, -xy * det_inv, xx * det_inv, opacity);
    valid = valid && opacity >= kAlphaThreshold;

    const float opt =
        logf(clamp_min(opacity, kAlphaThreshold) * kInvAlphaThreshold);
    p.opacity_power_threshold[i] = opt;
    const float extent =
        p.tight_opacity ? clamp_max(sqrtf(2.0f * opt), kExtentSigma)
                        : kExtentSigma;

    const float mid = 0.5f * (xx + yy);
    const float lam = mid + sqrtf(clamp_min(mid * mid - det_safe, kMinLambda));
    const float radius = extent * sqrtf(lam);
    valid = valid && radius > 0.0f;
    p.radius[i] = radius;

    // world2ndc and ndc2pix.
    float ph[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ph[j] = mx * Pm[j] + my * Pm[4 + j] + mz * Pm[8 + j] + Pm[12 + j];
    }
    const float rcp_w = 1.0f / (ph[3] + kNdcWEps);
    const float px = ((ph[0] * rcp_w + 1.0f) * static_cast<float>(p.width)
                      - 1.0f) * 0.5f;
    const float py = ((ph[1] * rcp_w + 1.0f) * static_cast<float>(p.height)
                      - 1.0f) * 0.5f;
    reinterpret_cast<float2*>(p.mean2d)[i] = make_float2(px, py);

    float ext_x = radius, ext_y = radius;
    if (p.rect_bounding) {
      ext_x = minimum(extent * sqrtf(xx), radius);
      ext_y = minimum(extent * sqrtf(yy), radius);
    }
    reinterpret_cast<float2*>(p.rect_dims)[i] = make_float2(ext_x, ext_y);

    // get_rect: a division by the Python tile size is a product with its
    // reciprocal.
    const float inv_tx = p.inv_tile_x, inv_ty = p.inv_tile_y;
    const float gx = static_cast<float>(p.grid_x);
    const float gy = static_cast<float>(p.grid_y);
    const int lo_x = static_cast<int>(
        clamp_both(floorf((px - ext_x) * inv_tx), 0.0f, gx));
    const int lo_y = static_cast<int>(
        clamp_both(floorf((py - ext_y) * inv_ty), 0.0f, gy));
    const int hi_x = static_cast<int>(
        clamp_both(ceilf((px + ext_x) * inv_tx), 0.0f, gx));
    const int hi_y = static_cast<int>(
        clamp_both(ceilf((py + ext_y) * inv_ty), 0.0f, gy));
    reinterpret_cast<int2*>(p.rect_min)[i] = make_int2(lo_x, lo_y);
    reinterpret_cast<int2*>(p.rect_max)[i] = make_int2(hi_x, hi_y);
    const int tile_count = max(hi_x - lo_x, 0) * max(hi_y - lo_y, 0);
    valid = valid && tile_count > 0;

    p.valid[i] = valid;
    p.radii[i] = valid ? static_cast<int>(ceilf(radius)) : 0;
    p.tiles_touched[i] = valid ? tile_count : 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s_pview[3 * tid + j] = pv[j];
    }
    view_z = pv[2];

    // The inverse-covariance payload: Sigma^-1 and Sigma^-1 (mean - campos).
    v[0] = mx - cam[0];
    v[1] = my - cam[1];
    v[2] = mz - cam[2];
    float* inv9 = s_inv9 + 9 * tid;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      inv9[e] = inv6[e];
    }
    inv9[6] = inv6[0] * v[0] + inv6[1] * v[1] + inv6[2] * v[2];
    inv9[7] = inv6[1] * v[0] + inv6[3] * v[1] + inv6[4] * v[2];
    inv9[8] = inv6[2] * v[0] + inv6[4] * v[1] + inv6[5] * v[2];
  }

  // torch.linalg.norm of (mean - campos): two lanes hold (x^2 + z^2) and
  // y^2 and add them in that order.
  const float norm = sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
  if (live) {
    p.depth[i] = p.distance ? norm : view_z;
  }

  if (n_sh > 0) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  if (live) {
    float rgb[3];
    bool clamped[3] = {false, false, false};
    if (n_sh > 0) {
      // eval_sh, each channel in the plain version's order.
      const float* sh = s_sh + tid * stride;
      const float x = v[0] / norm, y = v[1] / norm, z = v[2] / norm;
      const float f1 = kShC1 * y, f2 = kShC1 * z, f3 = kShC1 * x;
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      const float g[5] = {kShC20 * xy, kShC21 * yz,
                          kShC22 * (2.0f * zz - xx - yy), kShC23 * xz,
                          kShC24 * (xx - yy)};
      const float h[7] = {kShC30 * y * (3.0f * xx - yy),
                          kShC31 * xy * z,
                          kShC32 * y * (4.0f * zz - xx - yy),
                          kShC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy),
                          kShC34 * x * (4.0f * zz - xx - yy),
                          kShC35 * z * (xx - yy),
                          kShC36 * x * (xx - 3.0f * yy)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float res = kShC0 * sh[c];
        if (n_sh > 3) {
          res = res - f1 * sh[3 + c] + f2 * sh[6 + c] - f3 * sh[9 + c];
          if (n_sh > 12) {
#pragma unroll
            for (int k = 0; k < 5; ++k) {
              res = res + g[k] * sh[3 * (4 + k) + c];
            }
            if (n_sh > 27) {
#pragma unroll
              for (int k = 0; k < 7; ++k) {
                res = res + h[k] * sh[3 * (9 + k) + c];
              }
            }
          }
        }
        res = res + 0.5f;
        clamped[c] = res < 0.0f;
        rgb[c] = clamp_min(res, 0.0f);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        rgb[c] = p.colors[3 * i + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_rgb[3 * tid + c] = rgb[c];
      s_clamped[3 * tid + c] = clamped[c];
    }
  }

  // The staged rows, written by the block as spans of its own rows.
  __syncthreads();
  for (int l = tid; l < 3 * rows; l += kBlock) {
    p.p_view[3 * base + l] = s_pview[l];
    p.rgb[3 * base + l] = s_rgb[l];
    p.clamped[3 * base + l] = s_clamped[l];
  }
  for (int l = tid; l < 9 * rows; l += kBlock) {
    p.cov3d_inv9[9 * base + l] = s_inv9[l];
  }
}

}  // namespace

// outputs: PreprocessOutput's 15 fields in its order (valid, p_view, mean2d,
// depth, conic_opacity, rgb, clamped, radius, radii, rect_dims, rect_min,
// rect_max, tiles_touched, cov3d_inv9, opacity_power_threshold).
extern "C" int stp_preprocess_fwd(
    const void* means3d, const void* opacities, const void* scales,
    const void* rotations, const void* shs, const void* colors_precomp,
    const void* viewmatrix, const void* projmatrix, const void* campos,
    int num_points, int sh_degree, int sh_coeffs, float scale_modifier,
    float focal_x, float focal_y, float lim_x, float lim_y, int width,
    int height, int tile_x, int tile_y, int distance_order,
    int rect_bounding, int tight_opacity_bounding, int proper_ewa_scaling,
    void* const* outputs, void* stream) {
  if (num_points <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  Params p;
  p.means3d = static_cast<const float*>(means3d);
  p.opacities = static_cast<const float*>(opacities);
  p.scales = static_cast<const float*>(scales);
  p.rotations = static_cast<const float*>(rotations);
  p.shs = static_cast<const float*>(shs);
  p.colors = static_cast<const float*>(colors_precomp);
  p.viewmatrix = static_cast<const float*>(viewmatrix);
  p.projmatrix = static_cast<const float*>(projmatrix);
  p.campos = static_cast<const float*>(campos);
  p.num_points = num_points;
  p.sh_floats = (sh_degree + 1) * (sh_degree + 1) * 3;
  p.sh_row = sh_coeffs * 3;
  p.scale_modifier = scale_modifier;
  p.focal_x = focal_x;
  p.focal_y = focal_y;
  p.lim_x = lim_x;
  p.lim_y = lim_y;
  p.width = width;
  p.height = height;
  p.inv_tile_x = static_cast<float>(1.0 / tile_x);
  p.inv_tile_y = static_cast<float>(1.0 / tile_y);
  p.grid_x = (width + tile_x - 1) / tile_x;
  p.grid_y = (height + tile_y - 1) / tile_y;
  p.distance = distance_order != 0;
  p.rect_bounding = rect_bounding != 0;
  p.tight_opacity = tight_opacity_bounding != 0;
  p.proper_ewa = proper_ewa_scaling != 0;
  p.valid = static_cast<bool*>(outputs[0]);
  p.p_view = static_cast<float*>(outputs[1]);
  p.mean2d = static_cast<float*>(outputs[2]);
  p.depth = static_cast<float*>(outputs[3]);
  p.conic_opacity = static_cast<float*>(outputs[4]);
  p.rgb = static_cast<float*>(outputs[5]);
  p.clamped = static_cast<bool*>(outputs[6]);
  p.radius = static_cast<float*>(outputs[7]);
  p.radii = static_cast<int*>(outputs[8]);
  p.rect_dims = static_cast<float*>(outputs[9]);
  p.rect_min = static_cast<int*>(outputs[10]);
  p.rect_max = static_cast<int*>(outputs[11]);
  p.tiles_touched = static_cast<int*>(outputs[12]);
  p.cov3d_inv9 = static_cast<float*>(outputs[13]);
  p.opacity_power_threshold = static_cast<float*>(outputs[14]);
  const int blocks = (num_points + kBlock - 1) / kBlock;
  preprocess_fwd_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K8 on this device: out[0] resident blocks per SM, out[1] registers a
// thread, out[2] local (spill) bytes a thread, out[3] shared bytes a block.
extern "C" int stp_preprocess_fwd_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, preprocess_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, preprocess_fwd_kernel, kBlock, 0));
}
