// Bilinear cube-map backward: pixel cotangents splatted into the texture
// gradient, every texel summed in one fixed order.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/cubemap.py (splat_grad
// -> _splat_kernel). That kernel walks its (tile, face) grid in order and
// read-modify-writes one dense texture window at a time, so its sums always
// come out in one order. Here the order is made explicit instead:
//
//   keys  (splat_keys_kernel): each kept pixel p emits the texel of each of
//         its four corners c as key[c * P + p]; a pixel with face -1
//         (padding) or with all three cotangents exactly 0 emits the
//         sentinel 6 R^2, past every texel.
//   order (the caller): a stable sort of the keys. Within a texel the
//         entries then run corner by corner, pixel by pixel: the order in
//         which the plain version's four index_add_ passes add them.
//   sum   (splat_sum_kernel): a block per 1,024 texels finds its entries
//         in the sorted keys (two warp-wide 32-way searches), zeroes the
//         block's texels in shared memory, then takes its entries 256 at a
//         time: every thread computes one entry's three products into
//         shared memory (all loads in flight together), then the first
//         entry of each texel's run in the chunk adds the run's products in
//         order onto the texel's running sum. Chunks follow one another, so
//         each texel's value is its entries summed one by one in the sorted
//         order, whatever the scheduling. The block then writes its 1,024
//         texels, touched or not, with 16-byte stores.
//
// No atomics, no counters, no order that depends on the scheduling. Every
// product and sum rounds separately (__fmul_rn, __fadd_rn, never fused), as
// the plain version's operations do, so on the same inputs the result is
// that of index_add_ on the CPU.
//
// The gradient is written in the texture parameter's own layout,
// (6, R, R, 3) contiguous. Bound: bytes. The function returns the dense
// gradient, so its 6 R^2 x 12 bytes are written whatever the pixels touch,
// and each pixel's 32 input bytes are read once; the keys and the sort are
// the price of the fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTexels = 1024;          // texels per block of the sum
constexpr int kKeyThreads = 256;

__global__ void __launch_bounds__(kKeyThreads)
splat_keys_kernel(const int* __restrict__ face, const int* __restrict__ u0,
                  const int* __restrict__ v0, const float* __restrict__ g,
                  int npix, int res, int* __restrict__ keys) {
  const int i = blockIdx.x * kKeyThreads + threadIdx.x;
  if (i >= npix) return;
  const int sentinel = 6 * res * res;
  const int f = face[i];
  const float g0 = g[(size_t)i * 3];
  const float g1 = g[(size_t)i * 3 + 1];
  const float g2 = g[(size_t)i * 3 + 2];
  const bool on = f >= 0 && (g0 != 0.0f || g1 != 0.0f || g2 != 0.0f);
  const int cell = on ? (f * res + v0[i]) * res + u0[i] : sentinel;
  keys[i] = cell;
  keys[npix + i] = on ? cell + 1 : sentinel;
  keys[2 * npix + i] = on ? cell + res : sentinel;
  keys[3 * npix + i] = on ? cell + res + 1 : sentinel;
}

// First index in keys[0, n) whose key is >= x (n if none), by one warp:
// 32 pivots a step, so about log32(n) dependent loads.
__device__ int warp_lower_bound(const int* __restrict__ keys, int n, int x,
                                int lane) {
  int lo = 0, hi = n;                  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int stride = (hi - lo) / 32;
    const int pivot = lo + (lane + 1) * stride - 1;
    const unsigned below = __ballot_sync(0xffffffffu, keys[pivot] < x);
    const int k = __popc(below);       // the pivots below x come first
    if (k < 32) hi = lo + (k + 1) * stride - 1;
    lo += k * stride;
  }
  const int idx = lo + lane;
  const unsigned below =
      __ballot_sync(0xffffffffu, idx < hi && keys[idx] < x);
  return lo + __popc(below);
}

__global__ void __launch_bounds__(kThreads)
splat_sum_kernel(const int* __restrict__ keys,
                 const long long* __restrict__ order,
                 const float* __restrict__ fu, const float* __restrict__ fv,
                 const float* __restrict__ g, int npix, int res,
                 float* __restrict__ dz) {
  __shared__ __align__(16) float s_out[kTexels * 3];
  __shared__ float s_val[kThreads * 3];
  __shared__ int s_key[kThreads];
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_texels = 6 * res * res;
  const int n = 4 * npix;
  const int t0 = blockIdx.x * kTexels;
  const int t1 = min(t0 + kTexels, n_texels);
  if (warp < 2) {
    const int at = warp_lower_bound(keys, n, warp == 0 ? t0 : t1, lane);
    if (lane == 0) s_range[warp] = at;
  }
  for (int k = tid; k < kTexels * 3; k += kThreads) s_out[k] = 0.0f;
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  for (int c0 = lo; c0 < hi; c0 += kThreads) {
    const int j = c0 + tid;
    int key = -1;
    if (j < hi) {
      key = keys[j];
      const long long e = order[j];
      const int corner = (e >= npix) + (e >= 2ll * npix) + (e >= 3ll * npix);
      const int p = (int)(e - (long long)corner * npix);
      const float wu = fu[p], wv = fv[p];
      // the plain version's products: (g (1 - wv)) (1 - wu) and so on
      const float a = (corner & 2) ? wv : __fsub_rn(1.0f, wv);
      const float b = (corner & 1) ? wu : __fsub_rn(1.0f, wu);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        s_val[tid * 3 + ch] =
            __fmul_rn(__fmul_rn(g[(size_t)p * 3 + ch], a), b);
    }
    s_key[tid] = key;
    __syncthreads();
    // the first entry of each run in this chunk adds the run in order
    if (j < hi && (tid == 0 || s_key[tid - 1] != key)) {
      float* out = s_out + (key - t0) * 3;
      float acc0 = out[0], acc1 = out[1], acc2 = out[2];
      for (int q = tid; q < kThreads && s_key[q] == key; ++q) {
        acc0 = __fadd_rn(acc0, s_val[q * 3]);
        acc1 = __fadd_rn(acc1, s_val[q * 3 + 1]);
        acc2 = __fadd_rn(acc2, s_val[q * 3 + 2]);
      }
      out[0] = acc0;
      out[1] = acc1;
      out[2] = acc2;
    }
    __syncthreads();
  }
  // the block's texels, touched or not: 16-byte stores where whole
  float* base = dz + (size_t)t0 * 3;
  const int nf = (t1 - t0) * 3;
  if (nf == kTexels * 3) {
    float4* out4 = reinterpret_cast<float4*>(base);
    const float4* s4 = reinterpret_cast<const float4*>(s_out);
    for (int k = tid; k < kTexels * 3 / 4; k += kThreads) out4[k] = s4[k];
  } else {
    for (int k = tid; k < nf; k += kThreads) base[k] = s_out[k];
  }
}

}  // namespace

// face, u0, v0: (npix,) i32; g: (npix, 3) f32; keys: (4 npix,) i32, written
// here.
extern "C" int splat_keys_launch(const int* face, const int* u0,
                                 const int* v0, const float* g, int npix,
                                 int res, int* keys, void* stream) {
  if (npix > 0)
    splat_keys_kernel<<<(npix + kKeyThreads - 1) / kKeyThreads, kKeyThreads,
                        0, (cudaStream_t)stream>>>(face, u0, v0, g, npix,
                                                   res, keys);
  return (int)cudaGetLastError();
}

// keys: (4 npix,) i32 sorted, order: (4 npix,) i64 the stable sort's
// permutation; fu, fv: (npix,) f32; g: (npix, 3) f32; dz: (6, res, res, 3)
// f32, 16-byte aligned, every element written here.
extern "C" int splat_sum_launch(const int* keys, const long long* order,
                                const float* fu, const float* fv,
                                const float* g, int npix, int res, float* dz,
                                void* stream) {
  const int n_texels = 6 * res * res;
  const int blocks = (n_texels + kTexels - 1) / kTexels;
  splat_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, order, fu, fv, g, npix, res, dz);
  return (int)cudaGetLastError();
}
