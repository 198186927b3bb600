// Ragged per-Gaussian segment sums of the per-intersection gradients.
//
// Replaces two TPU kernels of bilateral_driving_tpu/ops/segsum_pallas.py:
// segment_sum (one stacked (16, cap) input) and segment_sum_rows (R separate
// (cap,) inputs landing at output rows row0 .. row0 + R - 1). The TPU
// kernels give each output block of G_BLK Gaussians its contiguous,
// disjoint input window [offsets[b * G], offsets[(b + 1) * G]) and stream
// that window through VMEM as masked matrix products. Here a warp owns a
// block of 32 consecutive Gaussians and streams its window:
//   - lane l loads offsets[g0 + l] and offsets[g0 + l + 1], so the warp
//     holds its window [A, B) and every segment start in its lanes;
//   - an empty window (dead capacity and culled Gaussians: many blocks on
//     the main path) writes its n_out x 32 zeros and stops;
//   - otherwise the warp walks [A, B) 32 entries at a time. Lane l takes
//     entry e = base + l, finds its owner among the 32 Gaussians by a
//     5-step binary search over the segment starts held in lanes, and loads
//     all its payload rows before reducing (up to 16 independent coalesced
//     loads in flight). A segmented inclusive sum over runs of one owner
//     (owners never decrease along the lanes), in as many shuffle steps as
//     the longest run needs (2 for runs of up to 4 entries, the common
//     case; 5 for a full warp), leaves each run's total in its last lane,
//     which adds it into the warp's accumulator in shared memory,
//     acc[row][owner]: one lane per owner at each step, so no race and no
//     atomics;
//   - each lane then writes its Gaussian's n_out rows: its sums at rows
//     row0 .. row0 + R - 1, zeros elsewhere (no memset before).
// A Gaussian owning all 170 tiles of a frame costs its warp 6 steps, not
// one thread 1,700 dependent adds. The order of the additions is fixed by
// the offsets alone, so the result is bit-identical from run to run.
// Both TPU kernels are this one kernel over an array of row pointers: the
// stacked input passes a base pointer and a row stride, the split input its
// R arrays.
//
// Output (n_out, n) f32: row r holds the sums of input row r - row0.
//
// Bound: bytes. Each entry's payload rows are read once, the offsets once,
// and each Gaussian's n_out sums written once, one add per float read. On
// the main path the write dominates: 10 rows x 2,195,456 Gaussians x 4 B =
// 87.8 MB of the 111 MB, 33 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kWarps = 4;                 // warps a block
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const float* p[kMaxRows];
};

__global__ void __launch_bounds__(32 * kWarps)
segsum_kernel(Rows rows, int n_rows, int row0, int n_out,
              const int* __restrict__ offsets, int n,
              float* __restrict__ out) {
  __shared__ float acc_all[kWarps][kMaxRows][32];
  const int lane = threadIdx.x & 31;
  const int g0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (g0 >= n) return;                    // the whole warp
  float (*acc)[32] = acc_all[threadIdx.x >> 5];
  const int lo = __ldg(offsets + min(g0 + lane, n));
  const int hi = __ldg(offsets + min(g0 + lane + 1, n));
  const int a = __shfl_sync(kFull, lo, 0);
  const int b = __shfl_sync(kFull, hi, 31);
  if (a < b) {
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < n_rows) acc[j][lane] = 0.0f;
    __syncwarp();
    for (int base = a; base < b; base += 32) {
      const int e = base + lane;
      const bool valid = e < b;
      // the last of the 32 Gaussians whose segment starts at or before e;
      // empty segments share their start with the next, which wins
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, lo, k + step) <= e) k += step;
      const int owner = k;
      float v[kMaxRows];
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j)
        v[j] = valid && j < n_rows ? __ldg(rows.p[j] + e) : 0.0f;
      // runs of one owner: their heads (every lane past the window is a
      // run of its own), each lane's place in its run, and the longest run,
      // which bounds the steps of the segmented sum (a step past it would
      // add nothing)
      const bool head = __shfl_up_sync(kFull, owner, 1) != owner ||
                        lane == 0 || !valid;
      const unsigned heads = __ballot_sync(kFull, head);
      const int pos = lane - (31 - __clz(heads & (kFull >> (31 - lane))));
      const int longest = (int)__reduce_max_sync(kFull, (unsigned)pos);
      for (int d = 1; d <= longest; d <<= 1) {
#pragma unroll
        for (int j = 0; j < kMaxRows; ++j)
          if (j < n_rows) {
            const float y = __shfl_up_sync(kFull, v[j], d);
            if (pos >= d) v[j] += y;
          }
      }
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (valid && last) {
#pragma unroll
        for (int j = 0; j < kMaxRows; ++j)
          if (j < n_rows) acc[j][owner] += v[j];
      }
      __syncwarp();
    }
  }
  const int g = g0 + lane;
  if (g < n)
    for (int r = 0; r < n_out; ++r) {
      const int j = r - row0;
      out[(size_t)r * n + g] =
          a < b && j >= 0 && j < n_rows ? acc[j][lane] : 0.0f;
    }
}

}  // namespace

// Input rows: n_rows (<= 16) f32 arrays of length cap in Gaussian-major
// order, either `rows` (device pointers, one per row) or, when rows is
// NULL, row j at base + j * stride; offsets: (n + 1,) i32, non-decreasing,
// clamped to cap; out: (n_out, n) f32.
extern "C" int segsum_launch(const float* base, long long stride,
                             const float* const* rows, int n_rows, int row0,
                             int n_out, const int* offsets, int n, float* out,
                             void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || row0 < 0 ||
      row0 + n_rows > n_out || n < 0)
    return -1;
  Rows r{};
  for (int i = 0; i < n_rows; ++i) r.p[i] = rows ? rows[i] : base + i * stride;
  if (n > 0) {
    const int per_block = 32 * kWarps;
    segsum_kernel<<<(n + per_block - 1) / per_block, 32 * kWarps, 0,
                    (cudaStream_t)stream>>>(r, n_rows, row0, n_out, offsets,
                                            n, out);
  }
  return (int)cudaGetLastError();
}
