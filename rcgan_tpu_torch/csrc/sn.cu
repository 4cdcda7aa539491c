// Spectral norm: one power-iteration step and the W / sigma rescale, float32,
// for a GROUP of weights in one launch; further down, its VJP
// (`sn_group_kernel_vjp`, its own note there), likewise a group a launch.
//
// Replaces the Pallas TPU kernel `_kernel` of `sn_fused` (rcgan_tpu/ops/
// pallas/sn_kernel.py), which held one W [m, cout] in VMEM and ran
//     v = l2n(u0 W^T),  u' = l2n(v W),  sigma = (v W) u'^T,  W / sigma
// back to back, one call per spectral-normed layer.  A discriminator pass
// has 15 such layers (eleven [1152, 128] weights among them); the
// projection embedding and the perm classifier are groups of one.
//
// What bounds it on an H100 is latency, neither FLOPs nor bytes: the chain
// v -> |v| -> t -> |t| -> sigma -> W/sigma needs an order across all of W,
// and all 15 weights of a pass (6.7 MB read, 6.7 MB written) would stream
// from HBM in 4 us.  The design spreads the chain of each weight over eight
// SMs and runs all the weights of a group side by side:
//
// - Grid = (8, weights), a thread-block CLUSTER of 8 blocks per weight:
//   15 x 8 = 120 blocks on 132 SMs in one launch.  Block r of a cluster
//   owns rows [r m / 8, (r + 1) m / 8): 144 x 128 float32 = 72 KB at
//   m = 1152, copied into shared memory once with 16-byte cp.async.  W is
//   read from device memory once and written once.
// - Pass 1, a = u0 W^T on the block's own rows (no exchange: rows are
//   local): G = min(32, next power of two >= cout) lanes per row, 32 / G
//   rows side by side in a warp (cout = 1: 32 rows a warp; cout = 10: 2),
//   four such row sets in flight before one butterfly reduction.
// - |a|^2: block partial, then the cluster's eight partials read through
//   distributed shared memory and added IN RANK ORDER by every block, so
//   each block holds the same bits.  v = a / (|a| + eps), kept in shared
//   memory.
// - Pass 2, t = v W in chunks of 4 G columns: lanes over columns, rows over
//   lane groups and warps, folded over the groups by shuffles and over the
//   warps in warp order; the eight blocks' partials again in rank order.
// - |t|, u' = t / (|t| + eps), sigma = t . u' in every block (same bits);
//   rank 0 writes u' and sigma; every block writes its rows of W / sigma
//   from shared memory.
// No atomics anywhere: a call gives the same bits on every run.
//
// sigma is formed as (v W) u'^T, the order in which the jnp reference
// `sn_math` evaluates `v @ w_mat @ u.T`; it saves a third GEMV.
//
// Any m >= 1 and any cout in [1, MAX_COUT]: a block whose row range is
// empty still joins the cluster barriers; rows that do not fit the shared
// tile are re-read from device memory (L2 at these sizes); v of a row range
// too long for shared memory is parked in the block's rows of the W / sigma
// output, which the last pass overwrites.
//
// Plain C interface, loaded with ctypes.  The weights' descriptors travel
// to the kernel by value in one struct (a __grid_constant__ parameter, no
// device-side table).  The entry point launches on the given stream with
// cudaLaunchKernelEx and the cluster attribute, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;
constexpr int ROWSETS = 4;       // row sets in flight per warp in both passes
constexpr int CHUNK_MAX = 128;   // columns per pass-2 chunk: 4 per lane
constexpr int MAX_WEIGHTS = 64;  // descriptors per launch: 64 x 48 bytes < 4 KB
constexpr float EPS = 1e-12f;    // added to the norm, as in sn_math

struct SnWeight {
  const float* w;   // [m, cout]
  const float* u0;  // [cout]
  float* wbar;      // [m, cout]
  float* u_new;     // [cout]
  float* sigma;     // [1]
  int m;
  int cout;
};

struct SnGroup {
  SnWeight w[MAX_WEIGHTS];
  // dynamic shared memory, in floats, each a multiple of 4: t (and u0
  // before it) | v | the block's rows of W
  int t_cap;
  int v_cap;
  int tile_cap;
};

// Sum over the block of one value per thread: lanes by shuffle, then the
// warps' sums in warp order by thread 0.  Every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += red[k];
    red[WARPS] = s;
  }
  __syncthreads();
  const float s = red[WARPS];
  __syncthreads();  // red may be reused after this
  return s;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// x_i = W_i . y for the block's rows i (W's rows at `wr`, y in shared
// memory), written to x[i * xstride]; returns this thread's part of
// sum_i x_i z_i (of sum_i x_i^2 where z is null).  Pass 1 of both kernels:
// G lanes per row, 32 / G rows side by side in a warp, ROWSETS row sets in
// flight before one butterfly reduction.
__device__ __forceinline__ float row_dots(const float* wr, int rows, int cout, int G,
                                          const float* y, float* x, int xstride, const float* z) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1), grp = lane / G, RW = 32 / G;
  const int set_rows = RW * ROWSETS;
  float part = 0.f;
  for (int base = warp * set_rows; base < rows; base += WARPS * set_rows) {
    float a[ROWSETS];
    const float* rp[ROWSETS];
    bool ok[ROWSETS];
#pragma unroll
    for (int s = 0; s < ROWSETS; ++s) {
      const int i = base + s * RW + grp;
      ok[s] = i < rows;
      rp[s] = wr + static_cast<size_t>(ok[s] ? i : base) * cout;
      a[s] = 0.f;
    }
    for (int j = sub; j < cout; j += G) {
      const float yj = y[j];
#pragma unroll
      for (int s = 0; s < ROWSETS; ++s) a[s] = fmaf(rp[s][j], yj, a[s]);
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < ROWSETS; ++s) a[s] += __shfl_xor_sync(0xffffffffu, a[s], off);
    }
    if (sub == 0) {
#pragma unroll
      for (int s = 0; s < ROWSETS; ++s) {
        if (ok[s]) {
          const int i = base + s * RW + grp;
          x[static_cast<size_t>(i) * xstride] = a[s];
          part += a[s] * (z == nullptr ? a[s] : z[i]);
        }
      }
    }
  }
  return part;
}

// The cluster's sum of one value per block, added in rank order, so every
// block gets the same bits.  `slot` is this block's shared word for it; the
// caller keeps the block alive (a later cluster barrier) until every block
// has read it.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float block_value,
                                             float* slot) {
  if (threadIdx.x == 0) *slot = block_value;
  cluster.sync();
  float s = 0.f;
  for (int r = 0; r < CLUSTER; ++r) s += *cluster.map_shared_rank(slot, r);
  return s;
}

// t = v W over the whole cluster's rows into t_s, the same bits in every
// block, with v_i = v_of(i) for the block's rows i.  Pass 2 of both kernels:
// a chunk of 4 G columns at a time, lanes over columns, rows over lane
// groups and warps, folded over the groups by shuffles, over the warps in
// warp order (`part`) and over the eight blocks in rank order (`xch_t`, read
// by the whole cluster).
template <typename VOf>
__device__ __forceinline__ void cluster_vw(cg::cluster_group& cluster, const float* wr, int rows,
                                           int cout, int G, VOf v_of, float* t_s,
                                           float (*part)[CHUNK_MAX], float* xch_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1), grp = lane / G, RW = 32 / G;
  const int set_rows = RW * ROWSETS;
  const int chunk = 4 * G;
  for (int c0 = 0; c0 < cout; c0 += chunk) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = warp * set_rows; base < rows; base += WARPS * set_rows) {
#pragma unroll
      for (int s = 0; s < ROWSETS; ++s) {
        const int i = base + s * RW + grp;
        if (i < rows) {
          const float vi = v_of(i);
          const float* row = wr + static_cast<size_t>(i) * cout + c0 + sub;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (c0 + k * G + sub < cout) acc[k] = fmaf(vi, row[k * G], acc[k]);
          }
        }
      }
    }
    for (int off = 16; off >= G; off >>= 1) {  // over the warp's row groups
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) part[warp][k * G + sub] = acc[k];
    }
    __syncthreads();
    const int j = c0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < chunk) {
      float s = 0.f;
      for (int k = 0; k < WARPS; ++k) s += part[k][threadIdx.x];
      xch_t[threadIdx.x] = s;
    }
    cluster.sync();
    if (threadIdx.x < chunk && j < cout) {
      float s = 0.f;
      for (int r = 0; r < CLUSTER; ++r) s += cluster.map_shared_rank(xch_t, r)[threadIdx.x];
      t_s[j] = s;
    }
    // every block has read this chunk before any block writes the next
    // one, and no block leaves while its shared memory is still being read
    cluster.sync();
  }
}

__global__ void __launch_bounds__(THREADS) sn_group_kernel(const __grid_constant__ SnGroup g) {
  extern __shared__ float4 dyn4[];
  __shared__ float red[WARPS + 1];
  __shared__ float part[WARPS][CHUNK_MAX];
  __shared__ float xch_t[CHUNK_MAX];  // read by the whole cluster
  __shared__ float xch_ss;            // likewise

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const SnWeight& d = g.w[blockIdx.y];
  const int m = d.m, cout = d.cout;

  const int lo = static_cast<int>(static_cast<long long>(rank) * m / CLUSTER);
  const int hi = static_cast<int>(static_cast<long long>(rank + 1) * m / CLUSTER);
  const int rows = hi - lo;
  const size_t n = static_cast<size_t>(rows) * cout;

  float* t_s = reinterpret_cast<float*>(dyn4);
  float* v_s = t_s + g.t_cap;
  float* tile = v_s + g.v_cap;
  const float* wsrc = d.w + static_cast<size_t>(lo) * cout;
  float* wdst = d.wbar + static_cast<size_t>(lo) * cout;

  // ---- the block's rows of W into shared memory, u0 into t_s
  const bool tile_fits = n <= static_cast<size_t>(g.tile_cap);
  const bool src16 = (reinterpret_cast<uintptr_t>(wsrc) & 15) == 0;
  if (tile_fits) {
    const size_t n4 = src16 ? n / 4 : 0;
    for (size_t i = threadIdx.x; i < n4; i += THREADS) cp_async16(tile + 4 * i, wsrc + 4 * i);
    for (size_t i = 4 * n4 + threadIdx.x; i < n; i += THREADS) tile[i] = wsrc[i];
  }
  for (int j = threadIdx.x; j < cout; j += THREADS) t_s[j] = d.u0[j];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* wr = tile_fits ? tile : wsrc;
  float* vbuf = rows <= g.v_cap ? v_s : wdst;
  const int vstride = rows <= g.v_cap ? 1 : cout;

  // lanes per row: the smallest power of two >= cout, at most 32
  int G = 32;
  while (G > 1 && (G >> 1) >= cout) G >>= 1;

  // ---- pass 1: a = u0 W^T on the block's rows, and the partial of |a|^2
  const float ss = row_dots(wr, rows, cout, G, t_s, vbuf, vstride, nullptr);
  // syncs: a is visible, u0 in t_s is done with
  const float ss_all = cluster_sum(cluster, block_sum(ss, red), &xch_ss);
  const float vnorm = sqrtf(ss_all) + EPS;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    float* p = vbuf + static_cast<size_t>(i) * vstride;
    *p = *p / vnorm;
  }
  __syncthreads();

  // ---- pass 2: t = v W
  cluster_vw(cluster, wr, rows, cout, G,
             [=](int i) { return vbuf[static_cast<size_t>(i) * vstride]; }, t_s, part, xch_t);

  // ---- u' = t / |t|, sigma = t . u', in every block alike
  float tt = 0.f;
  for (int j = threadIdx.x; j < cout; j += THREADS) tt += t_s[j] * t_s[j];
  const float tnorm = sqrtf(block_sum(tt, red)) + EPS;
  float st = 0.f;
  for (int j = threadIdx.x; j < cout; j += THREADS) {
    const float t = t_s[j];
    const float u = t / tnorm;
    if (rank == 0) d.u_new[j] = u;
    st += t * u;
  }
  const float sigma = block_sum(st, red);
  if (rank == 0 && threadIdx.x == 0) *d.sigma = sigma;

  // ---- the block's rows of W / sigma
  const bool dst16 = (reinterpret_cast<uintptr_t>(wdst) & 15) == 0;
  const size_t n4 = (dst16 && (tile_fits || src16)) ? n / 4 : 0;
  const float4* wr4 = reinterpret_cast<const float4*>(wr);
  float4* out4 = reinterpret_cast<float4*>(wdst);
  for (size_t i = threadIdx.x; i < n4; i += THREADS) {
    float4 x = wr4[i];
    x.x /= sigma;
    x.y /= sigma;
    x.z /= sigma;
    x.w /= sigma;
    out4[i] = x;
  }
  for (size_t i = 4 * n4 + threadIdx.x; i < n; i += THREADS) wdst[i] = wr[i] / sigma;
}

// ---------------------------------------------------------------------------
// The VJP: the gradient of W from the cotangents of (W / sigma, u', sigma),
// for a GROUP of weights in one launch.
//
// Stands for `sn_fused`'s `_bwd` (rcgan_tpu/ops/pallas/sn_kernel.py), which
// re-runs `sn_math` under `jax.vjp` from the saved (W, u0): gradients flow
// through the power iteration, not around it.  With a = u0 W^T,
// v = a / (|a| + eps), t = v W, u' = t / (|t| + eps), sigma = t . u' and the
// cotangents Gbar (of W / sigma), gu (of u') and gsigma (of sigma; either
// of the last two may be null, read as zero):
//     sbar = gsigma - sum(Gbar * W) / sigma^2
//     ubar = gu + sbar t
//     tbar = sbar u' + ubar / (|t| + eps) - t (t . ubar) / ((|t| + eps)^2 |t|)
//     vbar = tbar W^T
//     abar = vbar / (|a| + eps) - a (a . vbar) / ((|a| + eps)^2 |a|)
//     dW   = Gbar / sigma + v^T tbar + abar^T u0
// all in float32, no term dropped.
//
// What bounds it is again the latency of a chain across all of W, not bytes:
// a critic pass's group reads W and Gbar and writes dW, 20 MB, 6 us at HBM
// rate, but a -> |a| -> t -> |t|, sigma -> tbar -> vbar -> a . vbar -> dW
// needs three folds across every row.  The forward kernel's geometry
// answers it the same way:
//
// - Grid = (8, weights), a cluster of 8 blocks per weight; block r owns rows
//   [r m / 8, (r + 1) m / 8) of W and of Gbar, both copied into shared memory
//   once with cp.async (2 x 72 KB at [1152, 128]); rows that do not fit are
//   re-read from device memory (L2 at these sizes).
// - Pass 1, a = u0 W^T on the block's rows (`row_dots`, the forward's pass
//   1), and the block's partials of |a|^2 and of sum(Gbar * W).
// - The cluster's eight partials of each, read through distributed shared
//   memory and added in rank order by every block (`cluster_sum`); pass 2,
//   t = v W (`cluster_vw`, the forward's pass 2), with v = a / (|a| + eps)
//   formed as it is read.
// - tbar in every block from t alone (block sums in warp order): the same
//   bits in all eight.
// - Pass 4, vbar = tbar W^T on the block's rows, and a . vbar across the
//   cluster in rank order; abar on the block's rows.
// - Pass 5 writes the block's rows of dW once, from Gbar, v, tbar, abar, u0.
// No atomics: a call gives the same bits on every run.  a and abar of a row
// range too long for shared memory live in a scratch buffer the caller
// passes (2 m floats a weight).
// ---------------------------------------------------------------------------

struct SnVjpWeight {
  const float* w;       // [m, cout]
  const float* u0;      // [cout]
  const float* gbar;    // [m, cout], the cotangent of W / sigma
  const float* gu;      // [cout], the cotangent of u', or null
  const float* gsigma;  // [1], the cotangent of sigma, or null
  float* dw;            // [m, cout]
  int m;
  int cout;
};

struct SnVjpGroup {
  SnVjpWeight w[MAX_WEIGHTS];
  // 2 (m_0 + m_1 + ...) floats (weight k's a and abar from 2 (m_0 + ... +
  // m_{k-1})), or null when every row range fits row_cap
  float* scratch;
  // dynamic shared memory, in floats, each a multiple of 4:
  // u0 | t | tbar (col_cap each) | a | abar (row_cap each) | W rows | Gbar rows (tile_cap each)
  int col_cap;
  int row_cap;
  int tile_cap;
};

__global__ void __launch_bounds__(THREADS)
    sn_group_kernel_vjp(const __grid_constant__ SnVjpGroup g) {
  extern __shared__ float4 dyn4[];
  __shared__ float red[WARPS + 1];
  __shared__ float part[WARPS][CHUNK_MAX];
  __shared__ float xch_t[CHUNK_MAX];  // read by the whole cluster
  __shared__ float xch_s[3];          // likewise: |a|^2, sum(Gbar * W), a . vbar

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const SnVjpWeight& d = g.w[blockIdx.y];
  const int m = d.m, cout = d.cout;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int lo = static_cast<int>(static_cast<long long>(rank) * m / CLUSTER);
  const int hi = static_cast<int>(static_cast<long long>(rank + 1) * m / CLUSTER);
  const int rows = hi - lo;
  const size_t n = static_cast<size_t>(rows) * cout;

  float* u0_s = reinterpret_cast<float*>(dyn4);
  float* t_s = u0_s + g.col_cap;
  float* tb_s = t_s + g.col_cap;
  float* a_s = tb_s + g.col_cap;
  float* ab_s = a_s + g.row_cap;
  float* wtile = ab_s + g.row_cap;
  float* gtile = wtile + g.tile_cap;
  const float* wsrc = d.w + static_cast<size_t>(lo) * cout;
  const float* gsrc = d.gbar + static_cast<size_t>(lo) * cout;
  float* dst = d.dw + static_cast<size_t>(lo) * cout;

  // ---- the block's rows of W and Gbar into shared memory, u0 beside them
  const bool tile_fits = n <= static_cast<size_t>(g.tile_cap);
  if (tile_fits) {
    const bool src16 = ((reinterpret_cast<uintptr_t>(wsrc) | reinterpret_cast<uintptr_t>(gsrc)) &
                        15) == 0;
    const size_t n4 = src16 ? n / 4 : 0;
    for (size_t i = threadIdx.x; i < n4; i += THREADS) {
      cp_async16(wtile + 4 * i, wsrc + 4 * i);
      cp_async16(gtile + 4 * i, gsrc + 4 * i);
    }
    for (size_t i = 4 * n4 + threadIdx.x; i < n; i += THREADS) {
      wtile[i] = wsrc[i];
      gtile[i] = gsrc[i];
    }
  }
  for (int j = threadIdx.x; j < cout; j += THREADS) u0_s[j] = d.u0[j];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* wr = tile_fits ? wtile : wsrc;
  const float* gr = tile_fits ? gtile : gsrc;
  float* a_b = a_s;
  float* ab_b = ab_s;
  if (rows > g.row_cap) {  // the caller passed scratch for this weight
    size_t off = 0;
    for (int k = 0; k < static_cast<int>(blockIdx.y); ++k) off += 2 * static_cast<size_t>(g.w[k].m);
    a_b = g.scratch + off + lo;
    ab_b = g.scratch + off + m + lo;
  }

  int G = 32;
  while (G > 1 && (G >> 1) >= cout) G >>= 1;
  const int sub = lane & (G - 1), grp = lane / G, RW = 32 / G;

  // ---- pass 1: a = u0 W^T, and the block's parts of |a|^2 and sum(Gbar * W)
  const float ss_part = row_dots(wr, rows, cout, G, u0_s, a_b, 1, nullptr);
  float gw = 0.f;
  for (size_t i = threadIdx.x; i < n; i += THREADS) gw = fmaf(gr[i], wr[i], gw);
  const float ss_all = cluster_sum(cluster, block_sum(ss_part, red), &xch_s[0]);
  const float gw_all = cluster_sum(cluster, block_sum(gw, red), &xch_s[1]);
  const float anorm = sqrtf(ss_all);
  const float an = anorm + EPS;

  // ---- pass 2: t = v W with v = a / (|a| + eps) formed as it is read
  cluster_vw(cluster, wr, rows, cout, G, [=](int i) { return a_b[i] / an; }, t_s, part, xch_t);

  // ---- tbar, in every block alike
  float tt = 0.f;
  for (int j = threadIdx.x; j < cout; j += THREADS) tt += t_s[j] * t_s[j];
  const float tnorm = sqrtf(block_sum(tt, red));
  const float tn = tnorm + EPS;
  float st = 0.f;
  for (int j = threadIdx.x; j < cout; j += THREADS) st += t_s[j] * (t_s[j] / tn);
  const float sigma = block_sum(st, red);
  const float sbar = (d.gsigma == nullptr ? 0.f : *d.gsigma) - gw_all / (sigma * sigma);
  float tu = 0.f;
  for (int j = threadIdx.x; j < cout; j += THREADS) {
    const float ub = (d.gu == nullptr ? 0.f : d.gu[j]) + sbar * t_s[j];
    tb_s[j] = ub;  // ubar for now: read back by this thread only
    tu += t_s[j] * ub;
  }
  const float c_t = block_sum(tu, red) / (tn * tn * tnorm);
  for (int j = threadIdx.x; j < cout; j += THREADS) {
    const float t = t_s[j];
    tb_s[j] = sbar * (t / tn) + tb_s[j] / tn - t * c_t;
  }
  __syncthreads();

  // ---- pass 4: vbar = tbar W^T on the block's rows, a . vbar across the cluster
  const float av_part = row_dots(wr, rows, cout, G, tb_s, ab_b, 1, a_b);
  const float av_all = cluster_sum(cluster, block_sum(av_part, red), &xch_s[2]);
  // every block has read every slot; none may leave before that
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const float c_a = av_all / (an * an * anorm);
  for (int i = threadIdx.x; i < rows; i += THREADS) ab_b[i] = ab_b[i] / an - a_b[i] * c_a;
  __syncthreads();

  // ---- pass 5: the block's rows of dW = Gbar / sigma + v^T tbar + abar^T u0
  for (int i = warp * RW + grp; i < rows; i += WARPS * RW) {
    const float vi = a_b[i] / an, abi = ab_b[i];
    const float* grow = gr + static_cast<size_t>(i) * cout;
    float* out = dst + static_cast<size_t>(i) * cout;
    for (int j = sub; j < cout; j += G) out[j] = grow[j] / sigma + vi * tb_s[j] + abi * u0_s[j];
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One launch of `kernel` over n clusters of CLUSTER blocks with `smem_bytes`
// of dynamic shared memory on `stream`; `configured` holds, per device, the
// largest dynamic size the kernel was allowed so far.
template <typename Group>
int launch_clusters(void (*kernel)(Group), const Group& g, int n, int smem_bytes, void* stream,
                    int* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || configured[device] < smem_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) configured[device] = smem_bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, static_cast<unsigned>(n), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The layout of SnGroup, for the caller that fills it.
int sn_max_weights() { return MAX_WEIGHTS; }
int sn_group_bytes() { return static_cast<int>(sizeof(SnGroup)); }

// `group`: an SnGroup in host memory with its first `n` descriptors set
// (all tensors float32, contiguous, on the device of `stream`) and the
// three shared-memory capacities; `smem_bytes` = 4 (t_cap + v_cap +
// tile_cap).  One launch of n clusters.
int sn_group_f32(const void* group, int n, int smem_bytes, void* stream) {
  const SnGroup* g = static_cast<const SnGroup*>(group);
  if (n < 1 || n > MAX_WEIGHTS || smem_bytes < 0 || (g->t_cap | g->v_cap | g->tile_cap) & 3 ||
      smem_bytes != 4 * (g->t_cap + g->v_cap + g->tile_cap))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    if (g->w[i].m < 1 || g->w[i].cout < 1 || g->w[i].cout > g->t_cap) return cudaErrorInvalidValue;
  }
  static int configured[64] = {0};
  return launch_clusters(sn_group_kernel, *g, n, smem_bytes, stream, configured);
}

// The layout of SnVjpGroup, for the caller that fills it.
int sn_vjp_bytes() { return static_cast<int>(sizeof(SnVjpGroup)); }

// `group`: an SnVjpGroup in host memory with its first `n` descriptors set
// (all tensors float32, contiguous, on the device of `stream`; gu and gsigma
// may be null), the scratch buffer where a row range exceeds row_cap, and
// the three capacities; `smem_bytes` = 4 (3 col_cap + 2 row_cap + 2
// tile_cap).  One launch of n clusters.
int sn_vjp_f32(const void* group, int n, int smem_bytes, void* stream) {
  const SnVjpGroup* g = static_cast<const SnVjpGroup*>(group);
  if (n < 1 || n > MAX_WEIGHTS || g->col_cap < 0 || g->row_cap < 0 || g->tile_cap < 0 ||
      (g->col_cap | g->row_cap | g->tile_cap) & 3 ||
      smem_bytes != 4 * (3 * g->col_cap + 2 * g->row_cap + 2 * g->tile_cap))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const SnVjpWeight& d = g->w[i];
    if (d.m < 1 || d.cout < 1 || d.cout > g->col_cap || !d.w || !d.u0 || !d.gbar || !d.dw ||
        (d.m / CLUSTER + (d.m % CLUSTER != 0) > g->row_cap && !g->scratch))
      return cudaErrorInvalidValue;
  }
  static int configured[64] = {0};
  return launch_clusters(sn_group_kernel_vjp, *g, n, smem_bytes, stream, configured);
}

const char* sn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
