// Inclusive prefix scans (sum, max, min) along the rows of an (R, M) array.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/scan_pallas.py
// (scan_rows, scan1d). The TPU kernel walks a row's 8192-lane blocks in its
// sequential grid and carries the running total in VMEM scratch from one
// grid step to the next. Hopper's blocks run in parallel and in no order,
// so nothing can be carried between them; the scan takes three passes:
//   1. each block scans one 1,024-element tile of a row in registers and
//      shared memory (a warp scan by __shfl_up_sync, then the scan of the
//      32 warp totals by warp 0), writes the tile's local scan and the
//      tile's total;
//   2. one block per row scans that row's tile totals in place, 1,024 at a
//      time with a carry;
//   3. every tile but a row's first combines the inclusive total of the
//      tiles before it into each of its elements.
// The identity is 0 for sum and the type's lowest or highest value for max
// and min, as in scan_pallas._identity. int32 sums wrap like torch.cumsum's
// in unsigned arithmetic, so on int32 (and for max and min on any type) the
// result is bit-exact; float32 sums associate per tile and then across
// tiles, not left to right.
//
// Bound: bytes. Each element must be read once and written once (8 B for
// int32 or float32) with one operation each; this design moves it three
// more times (pass 3 reads and writes the output again, pass 1 writes it).
// A single-pass decoupled look-back scan would reach the bound.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;   // one element per thread, one tile a block
constexpr int kWarps = kThreads / 32;

struct Sum {
  __device__ static float apply(float a, float b) { return a + b; }
  __device__ static int apply(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
  __device__ static float identity(float) { return 0.0f; }
  __device__ static int identity(int) { return 0; }
};

struct Max {
  __device__ static float apply(float a, float b) { return b > a ? b : a; }
  __device__ static int apply(int a, int b) { return b > a ? b : a; }
  __device__ static float identity(float) { return -FLT_MAX; }
  __device__ static int identity(int) { return INT_MIN; }
};

struct Min {
  __device__ static float apply(float a, float b) { return b < a ? b : a; }
  __device__ static int apply(int a, int b) { return b < a ? b : a; }
  __device__ static float identity(float) { return FLT_MAX; }
  __device__ static int identity(int) { return INT_MAX; }
};

// Inclusive scan of one value per thread over the block, in thread order.
// Ends with a barrier, so `warp_tot` may be reused right after.
template <typename T, class Op>
__device__ T block_scan(T v, T* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = Op::apply(y, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = warp_tot[lane];   // kWarps == 32: one total per lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = Op::apply(y, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = Op::apply(warp_tot[warp - 1], v);
  __syncthreads();
  return v;
}

// pass 1: grid (tiles, rows)
template <typename T, class Op>
__global__ void scan_tiles(const T* __restrict__ x, T* __restrict__ out,
                           T* __restrict__ totals, int m, int tiles) {
  __shared__ T warp_tot[kWarps];
  const int row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const T ident = Op::identity(T());
  const T v = i < m ? x[(int64_t)row * m + i] : ident;
  const T s = block_scan<T, Op>(v, warp_tot);
  if (i < m) out[(int64_t)row * m + i] = s;
  if (threadIdx.x == kThreads - 1)
    totals[(int64_t)row * tiles + blockIdx.x] = s;
}

// pass 2: grid (rows); each row's tile totals scanned in place
template <typename T, class Op>
__global__ void scan_totals(T* __restrict__ totals, int tiles) {
  __shared__ T warp_tot[kWarps];
  __shared__ T carry_s;
  T* t = totals + (int64_t)blockIdx.x * tiles;
  const T ident = Op::identity(T());
  T carry = ident;
  for (int base = 0; base < tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const T v = i < tiles ? t[i] : ident;
    const T s = Op::apply(carry, block_scan<T, Op>(v, warp_tot));
    if (i < tiles) t[i] = s;
    if (threadIdx.x == kThreads - 1) carry_s = s;
    __syncthreads();
    carry = carry_s;
    __syncthreads();
  }
}

// pass 3: grid (tiles - 1, rows); tile b + 1 takes the total of tiles 0..b
template <typename T, class Op>
__global__ void add_carry(T* __restrict__ out, const T* __restrict__ totals,
                          int m, int tiles) {
  const int row = blockIdx.y;
  const int tile = blockIdx.x + 1;
  const int64_t i = (int64_t)tile * kThreads + threadIdx.x;
  if (i >= m) return;
  const T c = totals[(int64_t)row * tiles + tile - 1];
  T* o = out + (int64_t)row * m + i;
  *o = Op::apply(c, *o);
}

template <typename T, class Op>
int run(const void* x, void* out, void* totals, int rows, int m,
        cudaStream_t stream) {
  const int tiles = (m + kThreads - 1) / kThreads;
  if (rows == 0 || m == 0) return 0;
  if (rows > 65535) return -1;
  scan_tiles<T, Op><<<dim3(tiles, rows), kThreads, 0, stream>>>(
      (const T*)x, (T*)out, (T*)totals, m, tiles);
  if (tiles > 1) {
    scan_totals<T, Op><<<rows, kThreads, 0, stream>>>((T*)totals, tiles);
    add_carry<T, Op><<<dim3(tiles - 1, rows), kThreads, 0, stream>>>(
        (T*)out, (const T*)totals, m, tiles);
  }
  return 0;
}

template <typename T>
int run_op(int op, const void* x, void* out, void* totals, int rows, int m,
           cudaStream_t stream) {
  switch (op) {
    case 0: return run<T, Sum>(x, out, totals, rows, m, stream);
    case 1: return run<T, Max>(x, out, totals, rows, m, stream);
    case 2: return run<T, Min>(x, out, totals, rows, m, stream);
    default: return -1;
  }
}

}  // namespace

// x, out: (rows, m) contiguous; totals: (rows, ceil(m / 1024)) scratch of
// the same type. dtype 0 = float32, 1 = int32; op 0 = sum, 1 = max, 2 = min.
extern "C" int scan_launch(const void* x, void* out, void* totals, int rows,
                           int m, int dtype, int op, void* stream) {
  int code;
  if (dtype == 0)
    code = run_op<float>(op, x, out, totals, rows, m, (cudaStream_t)stream);
  else if (dtype == 1)
    code = run_op<int>(op, x, out, totals, rows, m, (cudaStream_t)stream);
  else
    code = -1;
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
