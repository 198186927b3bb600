// Per-intersection expansion: per-Gaussian table -> (sort key, gid, 10 feature rows).
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/expand_pallas.py
// (expand_gather -> _run_kernel -> _expand_kernel). The TPU kernel walks
// 128-entry windows of a lane-major table because a TPU cannot gather one
// column per lane; on Hopper every entry simply finds its own Gaussian.
//
// One thread per entry m < cap:
//   * g = the last Gaussian whose segment starts at or before m, by a binary
//     search in `offsets` (offsets are non-decreasing, so this is exactly the
//     scatter-max + cummax fill of binning._fill_monotone);
//   * the entry's tile is the k-th tile of g's span, k = m - seg_start, with
//     integer division (the TPU kernel's f32 floor is exact at these sizes);
//   * key = tile << (31 - tile_bits) | depth_bits >> tile_bits, as
//     binning.pack_keys packs it;
//   * entries at or past num_isects get key INT_MAX, gid n_orig and
//     log-opacity -30, like expand_gather_xla.
//
// Bound: bytes. Each entry reads one 16-float table column (neighbouring
// threads mostly share g, so the reads coalesce into few lines) and writes
// 48 bytes; the binary search touches log2(N) offsets, mostly from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat0 = 4;    // first feature row of the table
constexpr int kNFeat = 10;   // x y a b c logop r g b depth
constexpr int kRowSeg = 3;   // segment start row
constexpr int kRowDepth = 13;
constexpr int kRowId = 14;
constexpr int kIntMax = 2147483647;

__global__ void expand_kernel(const float* __restrict__ table, int n,
                              int stride, const int* __restrict__ offsets,
                              const int* __restrict__ num_isects, int cap,
                              int ntx, int tile_bits, int n_orig,
                              int* __restrict__ key, int* __restrict__ gid,
                              float* __restrict__ feats) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= cap) return;
  if (m >= *num_isects) {
    key[m] = kIntMax;
    gid[m] = n_orig;
    for (int r = 0; r < kNFeat; ++r)
      feats[(size_t)r * cap + m] = (r == 5) ? -30.0f : 0.0f;
    return;
  }
  // last i in [0, n) with offsets[i] <= m; offsets[0] == 0 <= m
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= m) lo = mid; else hi = mid;
  }
  const float* col = table + lo;
  const int k = m - (int)col[(size_t)kRowSeg * stride];
  const int sw = max((int)col[(size_t)2 * stride], 1);
  const int ty = (int)col[(size_t)1 * stride] + k / sw;
  const int tx = (int)col[0] + k % sw;
  const int tile = ty * ntx + tx;
  const int dbits =
      __float_as_int(fmaxf(col[(size_t)kRowDepth * stride], 0.0f));
  key[m] = (tile << (31 - tile_bits)) | (dbits >> tile_bits);
  gid[m] = (int)col[(size_t)kRowId * stride];
  for (int r = 0; r < kNFeat; ++r)
    feats[(size_t)r * cap + m] = col[(size_t)(kFeat0 + r) * stride];
}

}  // namespace

// table: (16, stride) f32, columns [0, n) used; offsets: (n + 1,) i32;
// num_isects: (1,) i32 on the device; key, gid: (cap,) i32; feats: (10, cap).
extern "C" int expand_gather_launch(const float* table, int n, int stride,
                                    const int* offsets, const int* num_isects,
                                    int cap, int ntx, int tile_bits,
                                    int n_orig, int* key, int* gid,
                                    float* feats, void* stream) {
  if (cap > 0) {
    const int threads = 256;
    const int blocks = (cap + threads - 1) / threads;
    expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, n, stride, offsets, num_isects, cap, ntx, tile_bits, n_orig,
        key, gid, feats);
  }
  return (int)cudaGetLastError();
}
