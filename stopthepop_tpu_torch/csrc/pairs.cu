// The pair stream of a frame: keys written once a Gaussian, CUB's radix
// sort over the key bits in use, and the tile ranges in one pass.
//
// Replaces no Pallas kernel: the JAX package expands the pairs in jnp
// (stopthepop_tpu/render/duplicate.py) and sorts them with jax.lax.sort
// (stopthepop_tpu/ops/sort.py), both left to XLA. The port's torch path
// (render/duplicate.py::expand_pairs and sort_expanded) runs ~60 launches
// that gather over every pair in int64. This is the reference's own design
// (rasterizer_impl.cu:221-413):
//
//   * stp_pairs_offsets: the run offsets, cub::DeviceScan over the tiles
//     each Gaussian touches, summed in 64 bits (the scan of
//     rasterizer_impl.cu:310-314); the host reads the last, the pair count;
//   * duplicate_with_keys_kernel: one thread a Gaussian writes its pairs,
//     row-major within its rect, in Gaussian-major order (forward.cu:25-65):
//     the 64-bit key tile << 32 | bits(depth), -0.0 made +0.0 as
//     ops/sort.py does, the pair's expansion slot as its value, and the
//     slot's Gaussian. No division: the inner loop steps x and y;
//   * stp_pairs_sort: cub::DeviceRadixSort::SortPairs over key bits
//     [0, 32 + bit_length(num_tiles - 1)) (rasterizer_impl.cu:344-352), on
//     a DoubleBuffer (no copy). The radix sort is stable and the bits above
//     the tile's are zero, so the permutation is torch.sort(stable=True)'s
//     on the same keys;
//   * identify_tile_ranges_kernel: one thread a sorted slot, and one past
//     the end, writes every field the consumers read: the tile (the key's
//     high word), the depth (its low word; the input's own bits where that
//     word is 0, so that -0.0 stays -0.0), the Gaussian, the slot as the
//     int64 permutation, and the tile ranges (rasterizer_impl.cu:133-158),
//     empty tiles included: a boundary between tiles a < b in the sorted
//     stream is the start of every tile in (a, b] and the end of every tile
//     in [a, b), with tile -1 before the first slot and num_tiles after the
//     last, so that each tile's start and end are torch.searchsorted's left
//     and right insertion points.
//
// What bounds it on an H100: bytes. The expansion reads 28 B a Gaussian
// (count, rect, depth, offset) and writes 16 B a pair (key, value, the
// slot's Gaussian); the radix sort reads and writes 12 B a pair in each of
// its ceil(end_bit / 8) passes; the last pass reads 16 B a pair and writes
// 20 B. Every write is the thread's own slot: no atomics, and the fields
// are the torch path's bits (kernels/pairs.py holds the plain version).
//
// Built by stopthepop_tpu_torch/kernels/build.py with nvcc for sm_90a; plain
// C interface, loaded with ctypes. Each entry point returns a cudaError_t.

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// The sum of the scan, in 64 bits whatever the count's type.
struct Add64 {
  __host__ __device__ __forceinline__ long long operator()(long long a,
                                                           long long b) const {
    return a + b;
  }
};

__global__ void __launch_bounds__(kBlock)
    duplicate_with_keys_kernel(const int* __restrict__ tiles_touched,
                               const int* __restrict__ rect_min,
                               const int* __restrict__ rect_max,
                               const float* __restrict__ depth,
                               const long long* __restrict__ offsets,
                               int num_points, int grid_x,
                               unsigned long long* __restrict__ keys,
                               int* __restrict__ values,
                               int* __restrict__ slot_gid) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= num_points) return;
  const int count = tiles_touched[g];
  if (count <= 0) return;
  const int x_begin = rect_min[2 * g];
  const int x_end = rect_max[2 * g];
  const float d = depth[g];
  // +0.0 for -0.0 (d == 0 holds for both); every other depth keeps its bits.
  const unsigned long long low = d == 0.0f ? 0ull : __float_as_uint(d);
  long long slot = offsets[g];
  int x = x_begin;
  int row = rect_min[2 * g + 1] * grid_x;
  for (int k = 0; k < count; ++k, ++slot) {
    keys[slot] = (static_cast<unsigned long long>(
                      static_cast<unsigned>(row + x)) << 32) | low;
    values[slot] = static_cast<int>(slot);
    slot_gid[slot] = g;
    if (++x == x_end) {
      x = x_begin;
      row += grid_x;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    identify_tile_ranges_kernel(const unsigned long long* __restrict__ keys,
                                const int* __restrict__ values,
                                const int* __restrict__ slot_gid,
                                const float* __restrict__ depth,
                                int num_rendered, int num_tiles,
                                int* __restrict__ tile_id,
                                float* __restrict__ depth_out,
                                int* __restrict__ gauss_id,
                                long long* __restrict__ orig_slot,
                                int* __restrict__ starts,
                                int* __restrict__ ends) {
  const int i = blockIdx.x * kBlock + threadIdx.x;  // a slot, or the end
  if (i > num_rendered) return;
  const int before = i > 0 ? static_cast<int>(keys[i - 1] >> 32) : -1;
  int tile = num_tiles;
  if (i < num_rendered) {
    const unsigned long long key = keys[i];
    const int slot = values[i];
    const int g = slot_gid[slot];
    const unsigned low = static_cast<unsigned>(key);
    tile = static_cast<int>(key >> 32);
    tile_id[i] = tile;
    depth_out[i] = low == 0u ? depth[g] : __uint_as_float(low);
    gauss_id[i] = g;
    orig_slot[i] = slot;
  }
  if (before == tile) return;
  for (int t = max(before + 1, 0); t <= min(tile, num_tiles - 1); ++t) {
    starts[t] = i;
  }
  for (int t = max(before, 0); t < min(tile, num_tiles); ++t) {
    ends[t] = i;
  }
}

int blocks(long long n) { return static_cast<int>((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" int stp_pairs_offsets_temp_bytes(int num_points,
                                            unsigned long long* bytes) {
  size_t need = 0;
  cudaError_t err = cub::DeviceScan::InclusiveScan(
      nullptr, need, static_cast<const int*>(nullptr),
      static_cast<long long*>(nullptr), Add64{}, num_points);
  *bytes = need;
  return static_cast<int>(err);
}

// offsets[0] = 0 and offsets[g + 1] = the pairs of Gaussians 0..g.
extern "C" int stp_pairs_offsets(const void* tiles_touched, void* offsets,
                                 int num_points, void* temp,
                                 unsigned long long temp_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* out = static_cast<long long*>(offsets);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(long long), s);
  if (err != cudaSuccess || num_points <= 0) return static_cast<int>(err);
  size_t bytes = temp_bytes;
  err = cub::DeviceScan::InclusiveScan(
      temp, bytes, static_cast<const int*>(tiles_touched), out + 1, Add64{},
      num_points, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stp_pairs_duplicate(const void* tiles_touched,
                                   const void* rect_min, const void* rect_max,
                                   const void* depth, const void* offsets,
                                   int num_points, int grid_x, void* keys,
                                   void* values, void* slot_gid, void* stream) {
  if (num_points <= 0) return static_cast<int>(cudaGetLastError());
  duplicate_with_keys_kernel<<<blocks(num_points), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tiles_touched),
      static_cast<const int*>(rect_min), static_cast<const int*>(rect_max),
      static_cast<const float*>(depth), static_cast<const long long*>(offsets),
      num_points, grid_x, static_cast<unsigned long long*>(keys),
      static_cast<int*>(values), static_cast<int*>(slot_gid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stp_pairs_sort_temp_bytes(int num_rendered, int end_bit,
                                         unsigned long long* bytes) {
  cub::DoubleBuffer<unsigned long long> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> values(nullptr, nullptr);
  size_t need = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, need, keys, values, num_rendered, 0, end_bit);
  *bytes = need;
  return static_cast<int>(err);
}

// Sorts (keys, values) by key bits [0, end_bit) into one of the two
// buffers of each; *selector is 0 where the result is in keys and values,
// 1 where it is in keys_alt and values_alt.
extern "C" int stp_pairs_sort(void* keys, void* keys_alt, void* values,
                              void* values_alt, int num_rendered, int end_bit,
                              void* temp, unsigned long long temp_bytes,
                              int* selector, void* stream) {
  *selector = 0;
  if (num_rendered <= 0) return static_cast<int>(cudaGetLastError());
  cub::DoubleBuffer<unsigned long long> k(
      static_cast<unsigned long long*>(keys),
      static_cast<unsigned long long*>(keys_alt));
  cub::DoubleBuffer<int> v(static_cast<int*>(values),
                           static_cast<int*>(values_alt));
  size_t bytes = temp_bytes;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, bytes, k, v, num_rendered, 0, end_bit,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  *selector = k.selector;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stp_pairs_identify(const void* keys, const void* values,
                                  const void* slot_gid, const void* depth,
                                  int num_rendered, int num_tiles,
                                  void* tile_id, void* depth_out,
                                  void* gauss_id, void* orig_slot,
                                  void* starts, void* ends, void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  identify_tile_ranges_kernel<<<blocks(num_rendered + 1LL), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const int*>(values), static_cast<const int*>(slot_gid),
      static_cast<const float*>(depth), num_rendered, num_tiles,
      static_cast<int*>(tile_id), static_cast<float*>(depth_out),
      static_cast<int*>(gauss_id), static_cast<long long*>(orig_slot),
      static_cast<int*>(starts), static_cast<int*>(ends));
  return static_cast<int>(cudaGetLastError());
}
