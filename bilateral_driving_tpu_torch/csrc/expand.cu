// Per-intersection expansion: per-Gaussian table -> (sort key, gid, 10 feature rows).
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/expand_pallas.py
// (expand_gather -> _run_kernel -> _expand_kernel). The TPU kernel walks
// 128-entry windows of a lane-major table because a TPU cannot gather one
// column per lane; on Hopper a block of 256 threads takes a window of 1,024
// entries, finds their Gaussians together and gathers one column per entry.
//
// Per block, window [m0, m0 + 1024):
//   * the window's first and last valid entries' Gaussians g0 and g1 (the
//     last Gaussian whose segment starts at or before m), each by one warp
//     searching all of `offsets` 32 pivots a step (5 dependent loads for
//     2.2 M Gaussians, where a binary search per entry made 21);
//   * offsets[g0 .. g1] staged in shared memory (up to 4,096 of them: the
//     main path's windows hold ~1,700), and each entry's owner, the last of
//     them at or before it, found there by a binary search (11 steps for
//     1,700, each a shared-memory load), each thread's four in step; this
//     is binning.fill_monotone's answer, the scatter-max and prefix max of
//     the segment starts;
//   * entry m (thread m % 256, so stores coalesce) reads its owner g's 15
//     table values: its tile is the k-th tile of g's span, k = m -
//     seg_start, with integer division (the TPU kernel's f32 floor is exact
//     at these sizes); key = tile << (31 - tile_bits) | depth_bits >>
//     tile_bits, as binning.pack_keys packs it;
//   * entries at or past num_isects get key INT_MAX, gid n_orig and
//     log-opacity -30, like expand_gather_xla; a window with none below
//     num_isects skips the search.
// Offsets are non-decreasing and a valid entry's owner is the one Gaussian
// whose segment holds it, so every key, gid and feature equals the plain
// version's bit for bit.
//
// Bound: bytes. Each entry reads one 16-float table column (neighbouring
// threads mostly share g, so the reads coalesce into few lines) and writes
// 48 bytes; the offsets of a window's Gaussians are read once, coalesced.
// The table's 32-byte sectors hold 8 Gaussians each, so reading the used
// ones reads nearly all of the live Gaussians' rows, about twice the bytes
// the bound counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                      // entries per thread
constexpr int kWindow = kThreads * kPer;     // entries per block
// offsets of a window's Gaussians staged in shared memory at most (a
// window past a long run of empty segments, e.g. dead capacity slots, has
// more and searches them where they are)
constexpr int kStaged = 4 * kWindow;
constexpr int kFeat0 = 4;    // first feature row of the table
constexpr int kNFeat = 10;   // x y a b c logop r g b depth
constexpr int kRowSeg = 3;   // segment start row
constexpr int kRowDepth = 13;
constexpr int kRowId = 14;
constexpr int kRows = 15;   // table rows read (row 15 is padding)
constexpr int kIntMax = 2147483647;

// Last i in [0, n) with offsets[i] <= m, by one whole warp: each step
// tests 32 evenly spaced pivots of the remaining range (offsets[0] == 0 <=
// m, so pivot 0 always passes) and keeps the span after the last that
// passes.
__device__ int warp_owner(const int* __restrict__ offsets, int n, int m) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;   // the answer lies in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool ok = p < hi && offsets[p] <= m;
    const unsigned pass = __ballot_sync(0xffffffffu, ok);
    lo += (31 - __clz(pass)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// Each of a thread's kPer entries m0 + u * kThreads + tid (clamped to
// `last`) gets owner[u], the last i < len with off[i] <= m, where off[0]
// <= every m: a branch-free binary search, the kPer searches in step so
// their loads overlap.
__device__ __forceinline__ void owners_in(const int* off, int len, int m0,
                                          int last, int* owner) {
  int m[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    m[u] = min(m0 + u * kThreads + (int)threadIdx.x, last);
    owner[u] = 0;
  }
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      owner[u] = off[owner[u] + half] <= m[u] ? owner[u] + half : owner[u];
    len -= half;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ table, int n, int stride,
              const int* __restrict__ offsets,
              const int* __restrict__ num_isects, int cap, int ntx,
              int tile_bits, int n_orig, int* __restrict__ key,
              int* __restrict__ gid, float* __restrict__ feats) {
  __shared__ int soff[kStaged];
  __shared__ int ends[2];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kWindow;
  const int valid = min(*num_isects, cap);   // entries below are valid
  const int last = min(m0 + kWindow, valid) - 1;

  // the window's Gaussians g0 .. g0 + len - 1
  int g0 = 0, len = 1;
  if (last >= m0) {   // the same for the whole block
    const int warp = tid >> 5;
    if (warp < 2) {
      const int g = warp_owner(offsets, n, warp == 0 ? m0 : last);
      if ((tid & 31) == 0) ends[warp] = g;
    }
    __syncthreads();
    g0 = ends[0];
    len = ends[1] - g0 + 1;
    if (len <= kStaged) {
      for (int i = tid; i < len; i += kThreads) soff[i] = offsets[g0 + i];
      __syncthreads();
    }
  }
  int own[kPer];
  if (len <= kStaged)
    owners_in(soff, len, m0, last, own);
  else
    owners_in(offsets + g0, len, m0, last, own);

  // every table value of the thread's entries is loaded before any is
  // used, so the loads overlap (an entry past `last` loads its clamped
  // owner's column and stores no value of it). The table is read once and
  // the outputs are written once, so both are marked as streaming data
  // (__ldcs, __stcs: first out of L2)
  float v[kPer][kRows];
  if (last >= m0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float* col = table + g0 + own[u];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        v[u][r] = __ldcs(col + (size_t)r * stride);
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int m = m0 + u * kThreads + tid;
    if (m >= cap) break;
    if (m >= valid) {
      __stcs(key + m, kIntMax);
      __stcs(gid + m, n_orig);
#pragma unroll
      for (int r = 0; r < kNFeat; ++r)
        __stcs(feats + (size_t)r * cap + m, (r == 5) ? -30.0f : 0.0f);
      continue;
    }
    const int k = m - (int)v[u][kRowSeg];
    const int sw = max((int)v[u][2], 1);
    const int ty = (int)v[u][1] + k / sw;
    const int tx = (int)v[u][0] + k % sw;
    const int tile = ty * ntx + tx;
    const int dbits = __float_as_int(fmaxf(v[u][kRowDepth], 0.0f));
    __stcs(key + m, (tile << (31 - tile_bits)) | (dbits >> tile_bits));
    __stcs(gid + m, (int)v[u][kRowId]);
#pragma unroll
    for (int r = 0; r < kNFeat; ++r)
      __stcs(feats + (size_t)r * cap + m, v[u][kFeat0 + r]);
  }
}

}  // namespace

// table: (16, stride) f32, columns [0, n) used; offsets: (n + 1,) i32,
// non-decreasing from 0; num_isects: (1,) i32 on the device; key, gid:
// (cap,) i32; feats: (10, cap).
extern "C" int expand_gather_launch(const float* table, int n, int stride,
                                    const int* offsets, const int* num_isects,
                                    int cap, int ntx, int tile_bits,
                                    int n_orig, int* key, int* gid,
                                    float* feats, void* stream) {
  if (cap > 0) {
    const int blocks = (cap + kWindow - 1) / kWindow;
    expand_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        table, n, stride, offsets, num_isects, cap, ntx, tile_bits, n_orig,
        key, gid, feats);
  }
  return (int)cudaGetLastError();
}
