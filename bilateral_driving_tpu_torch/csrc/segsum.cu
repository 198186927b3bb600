// Ragged per-Gaussian segment sums of the per-intersection gradients.
//
// Replaces two TPU kernels of bilateral_driving_tpu/ops/segsum_pallas.py:
// segment_sum (one stacked (16, cap) input) and segment_sum_rows (R separate
// (cap,) inputs landing at output rows row0 .. row0 + R - 1). The TPU
// kernels stream each block's input window through VMEM and reduce it as
// masked matrix products, because a TPU has no cheap per-lane gather. On
// Hopper one thread owns one Gaussian g and adds its own contiguous range
// [offsets[g], offsets[g + 1]) in index order, one input row at a time;
// neighbouring threads read neighbouring ranges, so the reads coalesce.
// Both TPU kernels are this one kernel over an array of row pointers: the
// stacked input passes pointers to its rows, the split input its R arrays.
//
// Output (n_out, n) f32: row r holds the sums of input row r - row0, and
// rows without an input are written as zeros (no memset before).
//
// Bound: bytes. Each entry's payload rows are read once and each
// Gaussian's n_out sums written once; there is one add per byte read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;

struct Rows {
  const float* p[kMaxRows];
};

__global__ void segsum_kernel(Rows rows, int n_rows, int row0, int n_out,
                              const int* __restrict__ offsets, int n,
                              float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int lo = offsets[g];
  const int hi = offsets[g + 1];
  for (int r = 0; r < n_out; ++r) {
    const int j = r - row0;
    float s = 0.0f;
    if (j >= 0 && j < n_rows) {
      const float* x = rows.p[j];
      for (int m = lo; m < hi; ++m) s += x[m];
    }
    out[(size_t)r * n + g] = s;
  }
}

}  // namespace

// rows: n_rows (<= 16) device pointers to (cap,) f32 arrays in
// Gaussian-major order; offsets: (n + 1,) i32, non-decreasing, clamped to
// cap; out: (n_out, n) f32.
extern "C" int segsum_launch(const float* const* rows, int n_rows, int row0,
                             int n_out, const int* offsets, int n, float* out,
                             void* stream) {
  if (n_rows > kMaxRows || row0 < 0 || row0 + n_rows > n_out) return -1;
  Rows r{};
  for (int i = 0; i < n_rows; ++i) r.p[i] = rows[i];
  if (n > 0) {
    const int threads = 256;
    segsum_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(r, n_rows, row0, n_out, offsets,
                                            n, out);
  }
  return (int)cudaGetLastError();
}
