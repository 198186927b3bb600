// Front-to-back tile compositing, forward, with the residuals of its
// backward.
//
// Replaces the TPU kernel bilateral_driving_tpu/ops/rasterize_pallas.py
// (rasterize_fwd -> _make_fwd_kernel). The TPU kernel turns each 128-entry
// chunk into matrix products and a prefix-product scan over (128, 1024)
// blocks; on Hopper one thread owns one pixel and walks the chunk in order.
//
// One thread-block cluster of k = 8 blocks per 32x32 tile, on 8 SMs (the
// largest portable cluster; fixed at compile time): block r of the cluster
// owns the tile's pixel rows [4 r, 4 r + 4), one thread per pixel. Every
// block walks the tile's sorted range [start, start + count) in the same
// global 128-aligned chunks the TPU kernel reads, starting at chunk
// start / 128.
// One block of 1,024 threads per tile walks them on one SM, so the
// heaviest tile sets the kernel's time while most SMs idle; splitting the
// pixels over a cluster cuts that walk k-fold.
//
// Per chunk and block: the next chunk's 10 feature rows are copied into
// shared memory with cp.async while this one is composited (two buffers);
// each entry of the tile's range is prepared once (the mean relative to
// the tile origin, a/2, c/2) and tested against each of the block's pixel
// rows (may_reach: the least sigma along the row, in double, with a margin
// far above f32 rounding); each warp owns one row and lists the entries
// that may reach it, in order. Each pixel then composites its row's list
// eight entries at a time (the eight alphas are independent of the
// transmittance, so they overlap; the blend selects instead of branching).
// Per entry and pixel:
//   sigma = 1/2 a dx^2 + 1/2 c dy^2 + b dx dy - logop,
//   dx, dy = pixel centre - mean, both relative to the tile origin;
//   alpha = min(exp(-sigma), 0.999), dropped below 1/255.
// An entry left off a row's list is one the gate drops at every pixel of
// the row, and the operations and their order are the one-block walk's, so
// the image and the residuals are bit-equal to it. On the render path's
// inputs most (entry, pixel) pairs lie in rows their Gaussian cannot reach.
//
// The per-tile early stop: after each chunk the tile stops once no pixel's
// transmittance is above 1e-4, the TPU kernel's stop at the same chunk
// boundaries. Each block ORs its own pixels (__syncthreads_or) and stores
// the flag into every block of the cluster (distributed shared memory,
// double-buffered by chunk parity), then arrives at a cluster barrier. It
// waits on that barrier only after compositing the next chunk, so the
// barrier's latency hides behind a chunk's work; then it ORs the k flags,
// and if the tile had stopped it puts back its state from before that
// chunk. All k blocks stop after the same chunk. Outputs r, g, b, the depth
// numerator and alpha = 1 - T_final.
//
// Residuals for csrc/rasterize_bwd.cu, written only when the caller passes
// their buffers (the render path passes null pointers and runs the
// kResiduals = false instance, which has no residual code at all):
// n_live[t], the chunks composited before the stop (cluster rank 0 writes
// it), and each live chunk's entry transmittance per pixel at
// ckpt[(ckpt_off[t] + c) * 1024 + p], each block its own pixels (and slot
// n_live[t] too where the tile stopped before its last chunk, a slot the
// backward never reads). ckpt_off is the exclusive prefix sum of the
// tiles' chunk counts, known before the launch, so the buffer needs at most
// cap / 128 + n_tiles slots. The TPU kernel checkpoints the same quantity
// (tc_ckpt, tc_side).
//
// Built with --fmad=false so that sigma and alpha round exactly as the
// plain PyTorch version's separate elementwise operations do.
//
// Bound: operations. Every live entry costs ~26 f32 operations and one exp
// per pixel, while its features are 40 bytes read once per block. The
// kernel is bound by issue: ~40 instructions per listed (entry, pixel)
// pair, and the heaviest tile's rows.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kChunk = 128;
constexpr int kNFeat = 10;   // x y a b c logop r g b depth
constexpr int kOut = 5;      // r g b depth alpha
constexpr int kCluster = 8;  // blocks per tile
constexpr int kThreads = kPix / kCluster;   // pixels of a block
constexpr int kRows = kThreads / kTile;     // pixel rows of a block
constexpr int kILP = 8;      // entries whose alphas are formed together
// the gate passes only where sigma <= ln(255) = 5.5413 (expf's error moves
// that by ~1e-6); an entry is dropped from a row only where the row's
// least sigma is above this by a margin far above f32 rounding
constexpr double kGateSigma = 5.5413 + 1e-3;

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// A cluster barrier in two halves: arrive (release: this thread's earlier
// stores, shared memory of other blocks included, are seen by every thread
// that has waited on the phase) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Whether an entry may pass the alpha gate at some pixel of the tile row
// whose centres lie at y = py and x = 0.5 .. 31.5 (all relative to the tile
// origin), from its prepared values as f32. Along the row sigma is the
// quadratic q(dx) = ha dx^2 + (b dy) dx + (hc dy^2 - lg) over dx in
// [0.5 - mx, 31.5 - mx]; its least value, in double, is compared with the
// gate plus 1e-5 of the terms' size, where the kernel's f32 sigma is
// within ~1e-6 of them. A row this returns false for drops the entry at
// every pixel, so leaving it out changes no bit. Non-finite values always
// may reach (the -inf logop of an entry outside the range never asks).
__device__ bool may_reach(float mx, float my, float ha, float b, float hc,
                          float lg, float py) {
  if (!(isfinite(mx) && isfinite(my) && isfinite(ha) && isfinite(b)
        && isfinite(hc) && isfinite(lg)))
    return true;
  const double dy = (double)py - (double)my;
  const double lo = 0.5 - (double)mx, hi = 31.5 - (double)mx;
  const double qa = ha, qb = (double)b * dy;
  const double qc = (double)hc * dy * dy - (double)lg;
  double least = fmin((qa * lo + qb) * lo + qc, (qa * hi + qb) * hi + qc);
  if (qa > 0.0) {
    const double x = -qb / (2.0 * qa);
    if (x > lo && x < hi) least = fmin(least, (qa * x + qb) * x + qc);
  }
  const double d = fmax(fabs(lo), fabs(hi));
  const double size = fabs(qa) * d * d + fabs((double)hc) * dy * dy
                      + fabs(qb) * d + fabs((double)lg);
  return !(least > kGateSigma + 1e-5 * size);
}

template <bool kResiduals>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
rasterize_fwd_kernel(const float* __restrict__ feats, int cap,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx,
                     float* __restrict__ out,
                     const int* __restrict__ ckpt_off,
                     float* __restrict__ ckpt, int* __restrict__ n_live) {
  // raw feature rows of two chunks; prepared entries (mx, my, a/2, b),
  // (c/2, logop, r, g), (b, depth, -, -), slot kChunk one that every pixel
  // drops; per entry, the block rows it may reach (bit r: row r); per row,
  // the entries that may reach it, in order, padded to whole groups with
  // slot kChunk; stop flags of two chunks
  __shared__ __align__(16) float raw[2][kNFeat][kChunk];
  __shared__ float4 prep[kChunk + 1][3];
  __shared__ unsigned char reach[kChunk];
  __shared__ short lists[kRows][kChunk + kILP];
  __shared__ int flags[2][kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / kCluster;
  const int p = rank * kThreads + threadIdx.x;
  const int start = starts[t];
  const int end = start + counts[t];
  const int fc = start / kChunk;
  const int nch = counts[t] > 0 ? (end + kChunk - 1) / kChunk - fc : 0;
  const float ox = (float)((t % ntx) * kTile);
  const float oy = (float)((t / ntx) * kTile);
  const float px = (float)(p % kTile) + 0.5f;
  const float py = (float)(p / kTile) + 0.5f;
  // warp w of the block composites the block's row w
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = rank * kRows;
  if (threadIdx.x == 0) {
    prep[kChunk][0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    prep[kChunk][1] = make_float4(0.0f, -INFINITY, 0.0f, 0.0f);
    prep[kChunk][2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  auto stage = [&](int c) {
    const float* src = feats + (size_t)(fc + c) * kChunk;
    for (int i = threadIdx.x; i < kNFeat * kChunk / 4; i += kThreads) {
      const int r = i / (kChunk / 4), q = i % (kChunk / 4);
      copy16(&raw[c & 1][r][4 * q], src + (size_t)r * cap + 4 * q);
    }
    copy_commit();
  };

  // phase 0 of the cluster barrier: every block of the cluster runs
  // before any block stores into another's shared memory
  cluster_arrive();
  if (nch > 0) stage(0);

  float T = 1.0f, cr = 0.0f, cg_ = 0.0f, cb = 0.0f, cd = 0.0f;
  bool stopped = false;
  int c = 0;
  for (; c < nch; ++c) {
    const int base = (fc + c) * kChunk;
    if constexpr (kResiduals)
      ckpt[((size_t)ckpt_off[t] + c) * kPix + p] = T;
    if (c + 1 < nch) {
      stage(c + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();   // chunk c's rows have landed, from every thread

    const int j0 = max(start - base, 0);
    const int j1 = min(end - base, kChunk);
    const float(*f)[kChunk] = raw[c & 1];
    for (int j = threadIdx.x; j < kChunk; j += kThreads) {
      const float mx = f[0][j] - ox, my = f[1][j] - oy;
      const float ha = 0.5f * f[2][j], hc = 0.5f * f[4][j];
      prep[j][0] = make_float4(mx, my, ha, f[3][j]);
      prep[j][1] = make_float4(hc, f[5][j], f[6][j], f[7][j]);
      prep[j][2] = make_float4(f[8][j], f[9][j], 0.0f, 0.0f);
      unsigned rows = 0;
      if (j >= j0 && j < j1)
        for (int r = 0; r < kRows; ++r)
          if (may_reach(mx, my, ha, f[3][j], hc, f[5][j],
                        (float)(row0 + r) + 0.5f))
            rows |= 1u << r;
      reach[j] = (unsigned char)rows;
    }
    __syncthreads();

    // this warp's row: the entries that may reach it, in order, by ballots
    short* list = lists[warp];
    int len = 0;
    for (int j = lane; j < kChunk; j += 32) {
      const bool take = (reach[j] >> warp) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (take) list[len + __popc(ballot & ((1u << lane) - 1u))] = (short)j;
      len += __popc(ballot);
    }
    if (lane < kILP) list[len + lane] = (short)kChunk;
    __syncwarp();

    // chunk c is composited before the cluster has decided whether the
    // tile stopped after chunk c - 1; if it had, the state from before
    // chunk c is put back
    const float sT = T, scr = cr, scg = cg_, scb = cb, scd = cd;
    // whole groups of kILP listed entries, in order; every pixel drops the
    // padding, slot kChunk (logop -inf: sigma +inf, alpha 0). The
    // transmittance and the sums are selected, not branched on, so the
    // group's alphas overlap
    for (int i = 0; i < len; i += kILP) {
      float al[kILP];
      float4 col[kILP];
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const int j = list[i + u];
        const float4 g0 = prep[j][0];
        const float4 g1 = prep[j][1];
        const float4 g2 = prep[j][2];
        const float dx = px - g0.x;
        const float dy = py - g0.y;
        const float sigma = g0.z * dx * dx + g1.x * dy * dy
                            + g0.w * dx * dy - g1.y;
        const float e = expf(-sigma);
        al[u] = e > 0.999f ? 0.999f : e;   // NaN stays NaN
        col[u] = make_float4(g1.z, g1.w, g2.x, g2.y);
      }
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const float alpha = al[u];
        const bool keep = alpha >= 1.0f / 255.0f;   // false for NaN
        const float w = alpha * T;
        const float nr = cr + w * col[u].x;
        const float ng = cg_ + w * col[u].y;
        const float nb = cb + w * col[u].z;
        const float nd = cd + w * col[u].w;
        const float nT = T * (1.0f - alpha);
        cr = keep ? nr : cr;
        cg_ = keep ? ng : cg_;
        cb = keep ? nb : cb;
        cd = keep ? nd : cd;
        T = keep ? nT : T;
      }
    }

    // this block's flag (also the barrier before the next chunk's entries
    // overwrite prep)
    const int any = __syncthreads_or(T > 1e-4f);
    // the previous phase: the start, or every block's flag of chunk c - 1
    cluster_wait();
    if (c > 0) {
      int go = 0;
      for (int r = 0; r < kCluster; ++r) go |= flags[(c - 1) & 1][r];
      if (!go) {
        T = sT; cr = scr; cg_ = scg; cb = scb; cd = scd;
        stopped = true;
        break;
      }
    }
    // this block's flag into slot `rank` of every block's flags; a block
    // stores this parity again only after waiting on the next phase, which
    // every block arrives at after reading it
    if ((int)threadIdx.x < kCluster)
      *cluster.map_shared_rank(&flags[c & 1][rank], (int)threadIdx.x) = any;
    cluster_arrive();
  }
  // the last phase: no block leaves while another may still store into
  // its shared memory (after a stop no phase is open), nor with a copy
  // into its own in flight
  if (!stopped) cluster_wait();
  copy_wait<0>();
  if constexpr (kResiduals) {
    if (p == 0) n_live[t] = c;
  }
  float* o = out + (size_t)t * kOut * kPix + p;
  o[0 * kPix] = cr;
  o[1 * kPix] = cg_;
  o[2 * kPix] = cb;
  o[3 * kPix] = cd;
  o[4 * kPix] = 1.0f - T;
}

template <bool kResiduals>
int launch(const float* feats, int cap, const int* starts, const int* counts,
           int n_tiles, int ntx, float* out, const int* ckpt_off, float* ckpt,
           int* n_live, void* stream) {
  // the cluster's shape is the kernel's own (__cluster_dims__)
  rasterize_fwd_kernel<kResiduals>
      <<<n_tiles * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
          feats, cap, starts, counts, ntx, out, ckpt_off, ckpt, n_live);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: (rows >= 10, cap) f32, rows 0..9 used, 16-byte aligned; starts,
// counts: (n_tiles,) i32; out: (n_tiles, 5, 1024) f32. ckpt_off (n_tiles,)
// i32, ckpt (slots, 1024) f32 and n_live (n_tiles,) i32 are all null or
// all set. A launch the card refuses (its clusters, say) returns its error.
extern "C" int rasterize_fwd_launch(const float* feats, int cap,
                                    const int* starts, const int* counts,
                                    int n_tiles, int ntx, float* out,
                                    const int* ckpt_off, float* ckpt,
                                    int* n_live, void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (ckpt != nullptr)
    return launch<true>(feats, cap, starts, counts, n_tiles, ntx, out,
                        ckpt_off, ckpt, n_live, stream);
  return launch<false>(feats, cap, starts, counts, n_tiles, ntx, out,
                       nullptr, nullptr, nullptr, stream);
}
