// Inclusive prefix scans (sum, max, min) along the rows of an (R, M) array,
// in one pass with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/scan_pallas.py
// (scan_rows, scan1d). The TPU kernel walks a row's 8192-lane blocks in its
// sequential grid and carries the running total in VMEM scratch from one
// grid step to the next. Hopper's blocks run in parallel and in no order;
// here each block scans one 8,192-element tile and learns the total of the
// tiles before it from their status words:
//   - a block takes its tile id from an atomic counter, not from blockIdx,
//     so every tile it waits on belongs to a block that is already running
//     (no grid size can deadlock); while the atomic is in flight it asks L2
//     for the tile it most likely gets. Ids run row by row, so a row's
//     first tile has no predecessor and the look-back stops at the row
//     start;
//   - each of the 16 warps owns 512 consecutive elements, loaded as 16 B
//     per thread where the row is aligned (masked scalar loads for a row's
//     tail), and scans them with __shfl_up_sync; the warp totals give the
//     tile's aggregate;
//   - the tile publishes its aggregate, then warp 0 reads the status words
//     of up to 32 predecessors at a time, until it meets one that holds an
//     inclusive prefix, and publishes its own inclusive prefix;
//   - a status word is one 64-bit relaxed store and load at device scope:
//     the low 32 bits the value, the high 32 bits (epoch << 2) | flag, flag
//     1 an aggregate and 2 an inclusive prefix. The wrapper passes a new
//     epoch each call, so an earlier call's words read as not ready, and
//     the counter value at the start of the call (`base`), so neither the
//     counter nor the words need clearing between calls.
// The identity is 0 for sum and the type's lowest or highest value for max
// and min, as in scan_pallas._identity. int32 sums wrap like torch.cumsum's
// in unsigned arithmetic, so on int32 (and for max and min on any type) the
// result is bit-exact. A float32 sum associates per warp, then per tile,
// then across tiles in the order the look-back meets aggregates and
// prefixes, which can differ from run to run in the last bits.
//
// Bound: bytes. Each element is read once and written once (8 B for int32
// or float32) at 3.35 TB/s, with one operation each; the status words add 8
// B and a few loads per 8,192 elements. At the main path's 2,195,456
// elements that is 5.2 us, about the cost of one launch, so the design
// keeps to one launch and no allocation or memset beside the output, and
// to tiles large enough that the look-back walks few windows (268 tiles,
// 9 windows of 32, at the main path's size).
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                  // 16 B loads per thread
constexpr int kWarpSpan = 32 * 4 * kVecs; // 512 elements a warp
constexpr int kTile = kWarps * kWarpSpan; // 8,192 elements a block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1, kPrefix = 2;
constexpr unsigned kMaxSpins = 1u << 24;  // look-back polls of one window

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

__device__ __forceinline__ unsigned to_bits(int v) { return (unsigned)v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ void from_bits(unsigned b, int* v) { *v = (int)b; }
__device__ __forceinline__ void from_bits(unsigned b, float* v) {
  *v = __uint_as_float(b);
}

// Status words are read and written whole at device scope, past the SM's
// own L1. The flag and its value are one single-copy-atomic 64-bit word, so
// the flag never arrives without its value and no ordering against other
// memory is needed: relaxed, not acquire and release.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename T>
__device__ __forceinline__ unsigned long long pack(T value, unsigned epoch,
                                                   unsigned flag) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | to_bits(value);
}

// Inclusive scan over the warp's lanes, in lane order.
template <typename T, class Op>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = Op::apply(y, v);
  }
  return v;
}

// Exclusive prefix of tile `tile` (> 0) of the row whose first tile's
// status word is row_status[0], by warp 0 after publishing the aggregate.
template <typename T, class Op>
__device__ T look_back(const unsigned long long* row_status, int tile,
                       unsigned epoch, int lane) {
  const T ident = Op::identity(T());
  T exclusive = ident;
  for (int nearest = tile - 1;; nearest -= 32) {
    // lane l reads the status of tile nearest - l; before the row start it
    // acts as an inclusive prefix of the identity
    const int t = nearest - lane;
    unsigned flag = kPrefix;
    unsigned bits = to_bits(ident);
    for (unsigned spins = 0;; ++spins) {
      if (t >= 0) {
        const unsigned long long w = load_status(row_status + t);
        const unsigned hi = (unsigned)(w >> 32);
        flag = (hi >> 2) == epoch ? (hi & 3u) : 0u;
        bits = (unsigned)w;
      }
      if (!__any_sync(kFull, flag == 0)) break;
      // a predecessor runs for microseconds; a word that stays unready
      // this long means a wrong epoch or counter base: fail the launch
      // rather than hang the card
      if (spins == kMaxSpins) __trap();
    }
    T v;
    from_bits(bits, &v);
    // the nearest predecessor holding an inclusive prefix ends the walk;
    // lanes 0 .. stop are combined, the farthest first
    const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    if (lane > stop) v = ident;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = Op::apply(__shfl_down_sync(kFull, v, d), v);
    exclusive = Op::apply(__shfl_sync(kFull, v, 0), exclusive);
    if (prefixes) return exclusive;
  }
}

template <typename T, class Op>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, T* __restrict__ out, int m,
            int tiles_per_row, unsigned long long* __restrict__ status,
            unsigned* __restrict__ counter, unsigned base, unsigned epoch) {
  __shared__ unsigned tile_id;
  __shared__ T warp_tot[kWarps];
  __shared__ T tile_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u) - base;
  {
    // while the atomic is in flight, bring into L2 the span this warp most
    // likely gets (blocks start in about the order of blockIdx.x); a hint
    // only, never read as data
    const int guess_row = blockIdx.x / tiles_per_row;
    const int64_t guess = (int64_t)(blockIdx.x - guess_row * tiles_per_row) *
                          kTile + warp * kWarpSpan;
    const T* gx = x + (int64_t)guess_row * m + guess;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = (i * 32 + lane) * 4;
      if (guess + j < m)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(gx + j));
    }
  }
  __syncthreads();
  const int id = (int)tile_id;
  const int row = id / tiles_per_row;
  const int tile = id - row * tiles_per_row;
  const int64_t start = (int64_t)tile * kTile + warp * kWarpSpan;
  const T* xw = x + (int64_t)row * m + start;
  T* ow = out + (int64_t)row * m + start;
  const int64_t rest = (int64_t)m - start;
  const int len = rest >= kWarpSpan ? kWarpSpan : (rest > 0 ? (int)rest : 0);
  const T ident = Op::identity(T());
  const bool vec = len == kWarpSpan &&
                   ((reinterpret_cast<uintptr_t>(xw) |
                     reinterpret_cast<uintptr_t>(ow)) & 15) == 0;

  // lane l holds elements (i * 32 + l) * 4 + c of its warp's span, so each
  // load instruction of the warp reads 512 consecutive bytes
  T v[kVecs][4];
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(xw) + i * 32 + lane);
      from_bits((unsigned)q.x, &v[i][0]);
      from_bits((unsigned)q.y, &v[i][1]);
      from_bits((unsigned)q.z, &v[i][2]);
      from_bits((unsigned)q.w, &v[i][3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = (i * 32 + lane) * 4 + c;
        v[i][c] = j < len ? xw[j] : ident;
      }
  }

  // scan the warp's span: each lane's four, then across lanes, carrying
  // the span's running total from one 128-element stretch to the next
  T carry = ident;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
#pragma unroll
    for (int c = 1; c < 4; ++c) v[i][c] = Op::apply(v[i][c - 1], v[i][c]);
    const T incl = warp_scan<T, Op>(v[i][3], lane);
    T excl = __shfl_up_sync(kFull, incl, 1);
    excl = Op::apply(carry, lane == 0 ? ident : excl);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[i][c] = Op::apply(excl, v[i][c]);
    carry = Op::apply(carry, __shfl_sync(kFull, incl, 31));
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();

  if (warp == 0) {
    T aggregate = ident;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) aggregate = Op::apply(aggregate,
                                                           warp_tot[w]);
    unsigned long long* row_status = status + (id - tile);
    T exclusive = ident;
    if (tile == 0) {
      if (lane == 0) store_status(row_status, pack(aggregate, epoch,
                                                    kPrefix));
    } else {
      if (lane == 0) store_status(row_status + tile,
                                 pack(aggregate, epoch, kAggregate));
      exclusive = look_back<T, Op>(row_status, tile, epoch, lane);
      if (lane == 0) store_status(row_status + tile,
                                   pack(Op::apply(exclusive, aggregate),
                                        epoch, kPrefix));
    }
    if (lane == 0) tile_prefix = exclusive;
  }
  __syncthreads();

  // the tile's prefix, then the warps before this one in the tile
  T prefix = tile_prefix;
  for (int w = 0; w < warp; ++w) prefix = Op::apply(prefix, warp_tot[w]);
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[i][c] = Op::apply(prefix, v[i][c]);
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<int4*>(ow)[i * 32 + lane] =
          make_int4((int)to_bits(v[i][0]), (int)to_bits(v[i][1]),
                    (int)to_bits(v[i][2]), (int)to_bits(v[i][3]));
  } else {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = (i * 32 + lane) * 4 + c;
        if (j < len) ow[j] = v[i][c];
      }
  }
}

template <typename T, class Op>
int run(const void* x, void* out, int rows, int m, void* scratch,
        unsigned base, unsigned epoch, cudaStream_t stream) {
  const long long per_row = ((long long)m + kTile - 1) / kTile;
  const long long tiles = per_row * rows;
  if (tiles == 0) return 0;
  if (tiles > INT_MAX) return -1;
  // scratch: the tile counter (its first 4 bytes), then one status word
  // per tile
  unsigned long long* words = (unsigned long long*)scratch;
  scan_kernel<T, Op><<<(unsigned)tiles, kThreads, 0, stream>>>(
      (const T*)x, (T*)out, m, (int)per_row, words + 1, (unsigned*)words,
      base, epoch);
  return 0;
}

template <typename T>
int run_op(int op, const void* x, void* out, int rows, int m, void* scratch,
           unsigned base, unsigned epoch, cudaStream_t stream) {
  switch (op) {
    case 0: return run<T, Sum>(x, out, rows, m, scratch, base, epoch, stream);
    case 1: return run<T, Max>(x, out, rows, m, scratch, base, epoch, stream);
    case 2: return run<T, Min>(x, out, rows, m, scratch, base, epoch, stream);
    default: return -1;
  }
}

}  // namespace

// x, out: (rows, m) contiguous; dtype 0 = float32, 1 = int32; op 0 = sum,
// 1 = max, 2 = min. scratch: 8 + 8 * rows * ceil(m / 8192) bytes, zeroed
// once when allocated; base: the value its counter holds at this call (it
// rises by the number of tiles each call); epoch: 1 .. 2^30 - 1, new for
// every call since the scratch was zeroed.
extern "C" int scan_launch(const void* x, void* out, int rows, int m,
                           int dtype, int op, void* scratch, unsigned base,
                           unsigned epoch, void* stream) {
  if (rows < 0 || m < 0 || epoch == 0 || epoch >= (1u << 30)) return -1;
  int code;
  if (dtype == 0)
    code = run_op<float>(op, x, out, rows, m, scratch, base, epoch,
                         (cudaStream_t)stream);
  else if (dtype == 1)
    code = run_op<int>(op, x, out, rows, m, scratch, base, epoch,
                       (cudaStream_t)stream);
  else
    code = -1;
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
