// Conditional batch-norm forward with an optional fused ReLU, float32 and
// bf16, in ONE cooperative launch.
//
// Replaces the Pallas TPU kernels `_moments_kernel` and `_apply_kernel` of
// `cond_batchnorm_fused` (rcgan_tpu/ops/pallas/norm_kernel.py): per-channel
// float32 sums of x and x^2 over (batch, spatial) of x [B, S, C], then
//     var = max(E[x^2] - mean^2, 0),
//     out = (x - mean) / sqrt(var + eps) * scale[label[b]] + offset[label[b]]
// (and max(out, 0) when the caller's next op is a ReLU), stored in x's type.
// The TPU's sequential grid carried the sums from step to step; blocks on
// the card run in no order, so per-block partials and a grid barrier take
// its place.
//
// What bounds it on an H100 is bytes: no tensor-core work, seven operations
// an element.  The least traffic is x read once and the output written once.
// The design:
//
// - One persistent, cooperative launch of at most one block of 1024 threads
//   per SM.  A block owns a contiguous range of rows and a block of channels
//   (TX 16-byte vectors wide; TY = 1024 / TX rows side by side).
// - Phase 1 streams the block's rows with 16-byte loads, keeps float32 sums
//   of x and x^2 per channel in registers, and folds them over the block's
//   TY row lanes in lane order into a [row blocks, C] partial.
// - The block's first rows stay in shared memory (up to ~206 KB a block:
//   with 132 SMs, every map up to ~27 MB whole, so the 6.6 MB maps of a
//   float32 generator pass at batch 100 and every map at the smaller serving
//   buckets are read from device memory once).
// - Grid barrier.  Phase 2: every block folds the partials of its channels
//   in row-block order (every block gets the same bits) into mean and
//   1 / sqrt(var + eps); the first row block of each channel block writes
//   them out for the backward.
// - Phase 3 applies the affine, gathering scale and offset by label itself
//   (into registers, again only when the row's example changes), walking
//   the block's rows BACKWARDS: the rows that did not fit shared
//   memory come first, the latest read first, while they still sit in the
//   50 MB L2; the rows in shared memory last.
// No atomics: a call gives the same bits on every run.
//
// The backward, `cond_bn_kernel_vjp`, is one cooperative launch on the same
// geometry.  The TPU kernel has no backward of its own (its `_bwd` is jnp
// under XLA); this replaces the ~30 float32 PyTorch launches of the plain
// backward.  With g' = g * (out > 0) under the ReLU (else g), x^ =
// (x - mean) * inv, per sample b and channel c A[b] = sum_S g' and
// Bs[b] = sum_S g' x^:
//     dx = inv * (g' * scale[l_b] - m1 - x^ * m2),
//     m1 = sum_b scale[l_b] A[b] / N,  m2 = sum_b scale[l_b] Bs[b] / N,
//     doffset[l] = sum_{b: l_b = l} A[b],  dscale[l] = sum_{b: l_b = l} Bs[b].
// It is bound by bytes too: g, x and out are read once per pass and dx
// written once, 14 bytes an element in bf16 (8 if the second pass found
// everything on chip).  The design:
//
// - Phase 1 streams the block's rows sample by sample (a sample's rows that
//   fall in the block are a segment), keeps float32 sums of g' and g' x^ per
//   channel in registers, and folds them over the row lanes in lane order
//   into the segment's sums: into slot (row block + sample) of a
//   [row blocks + B - 1, C] buffer, each slot one (block, sample) pair.  A
//   column's thread adds scale[l_b] times them into the block's partials of
//   m1 and m2, in sample order.  The block's first rows of g' and x stay in
//   shared memory, as in the forward.
// - Grid barrier.  Phase 2: every block folds the partials of m1 and m2 of
//   its channels in row-block order (the same bits in every block); the
//   table gradients are split over every thread of the grid, one (label,
//   channel) each: the samples in index order, each sample's segments in
//   block order, added where the sample's label is the row's (a row of no
//   sample is 0).
// - Phase 3 writes dx, computed as a * g' - (e + (x - mean) * w) with
//   a = inv * scale[l_b], e = inv * m1, w = inv^2 * m2 (the formula above,
//   regrouped so that four per-channel values stay in registers), walking
//   the rows backwards as the forward does.
// dx or the tables are skipped where no gradient is asked for.  No atomics.
// The row loops take one row a thread at a time: 1024 threads' 16-byte
// loads keep enough bytes in flight, and unrolling them spilled registers
// and ran 3-7% slower on an H100 (PERF.md, section 6).
//
// Any C: a tensor whose rows are not a whole number of aligned 16-byte
// vectors takes the one-element-per-thread instantiation.
//
// Plain C interface, loaded with ctypes.  The entry points launch on the
// given stream with cudaLaunchCooperativeKernel, do not synchronise,
// allocate nothing (the caller passes the stats, partials and output
// buffers) and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;

struct Args {
  const void* x;        // [n_rows, C], T
  const void* labels;   // [n_rows / S], int32 or int64
  const float* scale;   // [n_labels, C]
  const float* offset;  // [n_labels, C]
  void* out;            // [n_rows, C], T
  float* stats;         // [2 + 2 rb, C]: mean, inv, partial sums, partial squares
  int n_rows, S, C;
  int label64;
  int tx;              // vectors across a channel block, a power of two <= 256
  int cb, rb;          // channel blocks and row blocks: the grid is cb * rb
  int rows_per_block;  // a multiple of THREADS / tx
  int keep_rows;       // rows of a block held in shared memory
  float eps;
  int relu;
};

struct VjpArgs {
  const void* g;        // [n_rows, C], T: the output's cotangent
  const void* x;        // [n_rows, C], T
  const void* out;      // [n_rows, C], T: the forward's output, whose sign masks g; or null
  const void* labels;   // [n_rows / S], int32 or int64
  const float* scale;   // [n_labels, C]
  const float* mean;    // [C]
  const float* inv;     // [C]
  void* dx;             // [n_rows, C], T; or null
  float* dscale;        // [n_labels, C]; or null
  float* doffset;       // [n_labels, C]; or null
  float* work;          // [2 rb + 2 (rb + B - 1), C]: partials of m1, m2, then segment sums
  int n_rows, S, C, n_labels;
  int label64;
  int tx, cb, rb, rows_per_block, keep_rows;
};

__device__ __forceinline__ long long label_of(const void* labels, int label64, int b) {
  return label64 ? static_cast<const long long*>(labels)[b] : static_cast<const int*>(labels)[b];
}

template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> {
  using type = float4;
  static __device__ __forceinline__ void unpack(const type& p, float (&v)[4]) {
    v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w;
  }
  static __device__ __forceinline__ type pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ void unpack(const type& p, float (&v)[8]) {
    const unsigned w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ type pack(const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Pack<float, 1> {
  using type = float;
  static __device__ __forceinline__ void unpack(const type& p, float (&v)[1]) { v[0] = p; }
  static __device__ __forceinline__ type pack(const float (&v)[1]) { return v[0]; }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const type& p, float (&v)[1]) {
    v[0] = __bfloat162float(p);
  }
  static __device__ __forceinline__ type pack(const float (&v)[1]) {
    return __float2bfloat16_rn(v[0]);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 1) cond_bn_kernel(const Args a) {
  using P = Pack<T, VEC>;
  using V = typename P::type;
  extern __shared__ uint4 dyn[];

  const int TX = a.tx, TY = THREADS / TX, TXV = TX * VEC;
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x / TX;
  const int cb = blockIdx.x % a.cb, rb = blockIdx.x / a.cb;
  const int CV = a.C / VEC;            // vectors per row
  const int cvec = cb * TX + tx;       // this thread's vector of channels
  const bool live = cvec < CV;
  const int r0 = rb * a.rows_per_block;
  const int r1 = min(a.n_rows, r0 + a.rows_per_block);

  float* red = reinterpret_cast<float*>(dyn);  // [TY, TXV]
  float* mean_s = red + THREADS * VEC;         // [TXV]
  float* inv_s = mean_s + TXV;                 // [TXV]
  V* keep = reinterpret_cast<V*>(inv_s + TXV);  // [keep_rows, TX]

  const V* x = reinterpret_cast<const V*>(a.x);
  V* out = reinterpret_cast<V*>(a.out);

  // ---- phase 1: the block's rows, once; sums in registers, rows into shared memory
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += TY) {
      const V p = x[static_cast<size_t>(r) * CV + cvec];
      if (r - r0 < a.keep_rows) keep[(r - r0) * TX + tx] = p;
      float v[VEC];
      P::unpack(p, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  // fold over the TY row lanes in lane order: sums, then squares
  float* part = a.stats + static_cast<size_t>(2) * a.C;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[ty * TXV + tx * VEC + k] = pass ? q[k] : s[k];
    __syncthreads();
    for (int col = threadIdx.x; col < TXV; col += THREADS) {
      const int c = cb * TXV + col;
      if (c < a.C) {
        float t = 0.f;
        for (int y = 0; y < TY; ++y) t += red[y * TXV + col];
        part[(static_cast<size_t>(pass) * a.rb + rb) * a.C + c] = t;
      }
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // ---- phase 2: the partials of this block's channels, in row-block order
  const float n = static_cast<float>(a.n_rows);
  for (int col = threadIdx.x; col < TXV; col += THREADS) {
    const int c = cb * TXV + col;
    if (c < a.C) {
      float ts = 0.f, tq = 0.f;
#pragma unroll 8
      for (int b = 0; b < a.rb; ++b) {
        ts += part[static_cast<size_t>(b) * a.C + c];
        tq += part[(static_cast<size_t>(a.rb) + b) * a.C + c];
      }
      const float mean = ts / n;
      const float var = fmaxf(tq / n - mean * mean, 0.f);
      const float inv = 1.0f / sqrtf(var + a.eps);
      mean_s[col] = mean;
      inv_s[col] = inv;
      if (rb == 0) {
        a.stats[c] = mean;
        a.stats[a.C + c] = inv;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: the affine by label (and the ReLU), the block's rows backwards
  const int mine = r1 - r0 - ty;  // this lane's rows are r0 + ty, r0 + ty + TY, ... below r1
  if (live && mine > 0) {
    float mean[VEC], inv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = mean_s[tx * VEC + k];
      inv[k] = inv_s[tx * VEC + k];
    }
    const int last = r0 + ty + (mine - 1) / TY * TY;
    int b = last / a.S, si = last % a.S;  // the row's example and its place in it
    int loaded = -1;                      // the example whose scale and offset are in registers
    float sc[VEC], of[VEC];
#pragma unroll 2
    for (int r = last; r >= r0; r -= TY) {
      const V p = (r - r0 < a.keep_rows) ? keep[(r - r0) * TX + tx]
                                         : x[static_cast<size_t>(r) * CV + cvec];
      if (b != loaded) {
        loaded = b;
        const long long lab = a.label64 ? static_cast<const long long*>(a.labels)[b]
                                        : static_cast<const int*>(a.labels)[b];
        const size_t at = static_cast<size_t>(lab) * a.C + static_cast<size_t>(cvec) * VEC;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) {
            const float4 t = reinterpret_cast<const float4*>(a.scale + at)[i];
            const float4 u = reinterpret_cast<const float4*>(a.offset + at)[i];
            sc[4 * i] = t.x, sc[4 * i + 1] = t.y, sc[4 * i + 2] = t.z, sc[4 * i + 3] = t.w;
            of[4 * i] = u.x, of[4 * i + 1] = u.y, of[4 * i + 2] = u.z, of[4 * i + 3] = u.w;
          }
        } else {
          sc[0] = a.scale[at];
          of[0] = a.offset[at];
        }
      }
      float v[VEC];
      P::unpack(p, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float y = (v[k] - mean[k]) * inv[k] * sc[k] + of[k];
        v[k] = (a.relu && y < 0.f) ? 0.f : y;  // a NaN stays a NaN, as torch.relu leaves it
      }
      out[static_cast<size_t>(r) * CV + cvec] = P::pack(v);
      si -= TY;
      while (si < 0) {
        si += a.S;
        --b;
      }
    }
  }
}

// VEC floats of a float32 table from element `at`, a multiple of VEC (the
// tables are 16-byte aligned where VEC is 4 or 8).
template <int VEC>
__device__ __forceinline__ void load_floats(const float* t, size_t at, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(t + at)[i];
      v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = t[at + k];
  }
}

// The samples whose labels a phase-2 thread compares at once, so that their
// segment loads are in flight together.
constexpr int SAMPLES_IN_FLIGHT = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 1) cond_bn_kernel_vjp(const VjpArgs a) {
  using P = Pack<T, VEC>;
  using V = typename P::type;
  extern __shared__ uint4 dyn[];

  const int TX = a.tx, TY = THREADS / TX, TXV = TX * VEC;
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x / TX;
  const int cb = blockIdx.x % a.cb, rb = blockIdx.x / a.cb;
  const int CV = a.C / VEC;
  const int cvec = cb * TX + tx;
  const bool live = cvec < CV;
  const int r0 = rb * a.rows_per_block;
  const int r1 = min(a.n_rows, r0 + a.rows_per_block);
  const int S = a.S, B = a.n_rows / a.S;
  const bool want_dx = a.dx != nullptr;
  const bool want_tables = a.dscale != nullptr || a.doffset != nullptr;

  float* red = reinterpret_cast<float*>(dyn);  // [TY, TXV]
  float* mean_s = red + THREADS * VEC;         // [TXV]
  float* inv_s = mean_s + TXV;                 // [TXV]
  float* e_s = inv_s + TXV;   // [TXV]: the block's partial of m1, then inv m1
  float* w_s = e_s + TXV;     // [TXV]: the block's partial of m2, then inv^2 m2
  V* keep_g = reinterpret_cast<V*>(w_s + TXV);                   // [keep_rows, TX]: g'
  V* keep_x = keep_g + static_cast<size_t>(a.keep_rows) * TX;   // [keep_rows, TX]: x

  const V* g = reinterpret_cast<const V*>(a.g);
  const V* x = reinterpret_cast<const V*>(a.x);
  const V* out = reinterpret_cast<const V*>(a.out);
  const size_t slots = static_cast<size_t>(a.rb) + B - 1;
  float* part = a.work;                                       // [2, rb, C]
  float* seg = a.work + static_cast<size_t>(2) * a.rb * a.C;  // [2, slots, C]

  for (int col = threadIdx.x; col < TXV; col += THREADS) {
    const int c = cb * TXV + col;
    mean_s[col] = c < a.C ? a.mean[c] : 0.f;
    inv_s[col] = c < a.C ? a.inv[c] : 0.f;
    e_s[col] = w_s[col] = 0.f;
  }
  __syncthreads();
  float mean[VEC], inv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mean[k] = mean_s[tx * VEC + k];
    inv[k] = inv_s[tx * VEC + k];
  }

  // ---- phase 1: the block's rows once, a sample at a time; g' and x into shared memory
  for (int b = r0 / S; b <= (r1 - 1) / S; ++b) {
    const int lo = max(r0, b * S), hi = min(r1, (b + 1) * S);
    float sa[VEC], sb[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) sa[k] = sb[k] = 0.f;
    if (live) {
#pragma unroll 1
      for (int r = lo + ty; r < hi; r += TY) {
        const size_t at = static_cast<size_t>(r) * CV + cvec;
        V pg = g[at];
        const V px = x[at];
        float vg[VEC], vx[VEC];
        P::unpack(pg, vg);
        P::unpack(px, vx);
        if (out != nullptr) {
          float vo[VEC];
          P::unpack(out[at], vo);
#pragma unroll
          for (int k = 0; k < VEC; ++k) vg[k] *= vo[k] > 0.f ? 1.f : 0.f;  // g * (out > 0)
          pg = P::pack(vg);  // exact: each element is g or a zero
        }
        if (r - r0 < a.keep_rows) {
          keep_g[(r - r0) * TX + tx] = pg;
          keep_x[(r - r0) * TX + tx] = px;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          sa[k] += vg[k];
          sb[k] = fmaf(vg[k], (vx[k] - mean[k]) * inv[k], sb[k]);
        }
      }
    }
    // fold the lanes that hold rows of the segment, in lane order: sums of g', then of g' x^
    const int lanes = min(TY, hi - lo);
    const long long lab = label_of(a.labels, a.label64, b);
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) red[ty * TXV + tx * VEC + k] = pass ? sb[k] : sa[k];
      __syncthreads();
      float* pm = pass ? w_s : e_s;
      for (int col = threadIdx.x; col < TXV; col += THREADS) {
        const int c = cb * TXV + col;
        if (c < a.C) {
          float t = 0.f;
          for (int y = 0; y < lanes; ++y) t += red[y * TXV + col];
          if (want_tables) seg[(pass * slots + rb + b) * a.C + c] = t;
          if (want_dx) pm[col] = fmaf(a.scale[lab * a.C + c], t, pm[col]);
        }
      }
      __syncthreads();
    }
  }
  if (want_dx) {
    for (int col = threadIdx.x; col < TXV; col += THREADS) {
      const int c = cb * TXV + col;
      if (c < a.C) {
        part[static_cast<size_t>(rb) * a.C + c] = e_s[col];
        part[(static_cast<size_t>(a.rb) + rb) * a.C + c] = w_s[col];
      }
    }
  }

  cg::this_grid().sync();

  // ---- phase 2: the tables, one (label, channel) per thread of the grid; the
  // samples in index order, each sample's segments in row-block order
  if (want_tables) {
    const int items = a.n_labels * a.C;
    for (int it = blockIdx.x * THREADS + threadIdx.x; it < items; it += gridDim.x * THREADS) {
      const int l = it / a.C, c = it % a.C;
      float ta = 0.f, tb = 0.f;
      for (int b0 = 0; b0 < B; b0 += SAMPLES_IN_FLIGHT) {
        float va[SAMPLES_IN_FLIGHT], vb[SAMPLES_IN_FLIGHT];
        bool hit[SAMPLES_IN_FLIGHT];
#pragma unroll
        for (int j = 0; j < SAMPLES_IN_FLIGHT; ++j) {
          const int b = b0 + j;
          hit[j] = b < B && label_of(a.labels, a.label64, b) == l;
          va[j] = vb[j] = 0.f;
          if (hit[j]) {
            const int k1 = ((b + 1) * S - 1) / a.rows_per_block;
            for (int k = b * S / a.rows_per_block; k <= k1; ++k) {  // slot = row block + sample
              va[j] += seg[(static_cast<size_t>(k) + b) * a.C + c];
              vb[j] += seg[(slots + k + b) * a.C + c];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < SAMPLES_IN_FLIGHT; ++j) {
          if (hit[j]) {
            ta += va[j];
            tb += vb[j];
          }
        }
      }
      if (a.doffset != nullptr) a.doffset[it] = ta;
      if (a.dscale != nullptr) a.dscale[it] = tb;
    }
  }
  if (!want_dx) return;
  // m1 and m2 of this block's channels, the partials in row-block order
  const float n = static_cast<float>(a.n_rows);
  for (int col = threadIdx.x; col < TXV; col += THREADS) {
    const int c = cb * TXV + col;
    if (c < a.C) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
      for (int j = 0; j < a.rb; ++j) {
        t1 += part[static_cast<size_t>(j) * a.C + c];
        t2 += part[(static_cast<size_t>(a.rb) + j) * a.C + c];
      }
      const float iv = inv_s[col];
      e_s[col] = iv * (t1 / n);
      w_s[col] = iv * iv * (t2 / n);
    }
  }
  __syncthreads();

  // ---- phase 3: dx, the block's rows backwards
  const int mine = r1 - r0 - ty;  // this lane's rows are r0 + ty, r0 + ty + TY, ... below r1
  if (live && mine > 0) {
    float e[VEC], w[VEC], al[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      e[k] = e_s[tx * VEC + k];
      w[k] = w_s[tx * VEC + k];
      al[k] = 0.f;
    }
    V* dx = reinterpret_cast<V*>(a.dx);
    const int last = r0 + ty + (mine - 1) / TY * TY;
    int b = last / S, si = last % S;  // the row's sample and its place in it
    int loaded = -1;                  // the sample whose inv * scale is in registers
#pragma unroll 1
    for (int r = last; r >= r0; r -= TY) {
      const size_t at = static_cast<size_t>(r) * CV + cvec;
      float vg[VEC], vx[VEC];
      if (r - r0 < a.keep_rows) {
        P::unpack(keep_g[(r - r0) * TX + tx], vg);
        P::unpack(keep_x[(r - r0) * TX + tx], vx);
      } else {
        P::unpack(g[at], vg);
        P::unpack(x[at], vx);
        if (out != nullptr) {
          float vo[VEC];
          P::unpack(out[at], vo);
#pragma unroll
          for (int k = 0; k < VEC; ++k) vg[k] *= vo[k] > 0.f ? 1.f : 0.f;
        }
      }
      if (b != loaded) {
        loaded = b;
        const long long lab = label_of(a.labels, a.label64, b);
        load_floats<VEC>(a.scale, static_cast<size_t>(lab) * a.C + static_cast<size_t>(cvec) * VEC,
                         al);
#pragma unroll
        for (int k = 0; k < VEC; ++k) al[k] *= inv_s[tx * VEC + k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) vg[k] = fmaf(al[k], vg[k], -fmaf(vx[k] - mean[k], w[k], e[k]));
      dx[at] = P::pack(vg);
      si -= TY;
      while (si < 0) {
        si += S;
        --b;
      }
    }
  }
}

template <auto KERNEL>
cudaError_t configure(int smem_bytes) {
  static int configured[64] = {0};  // largest dynamic size asked for, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || configured[device] < smem_bytes) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) configured[device] = smem_bytes;
  }
  return cudaSuccess;
}

template <auto KERNEL>
int max_blocks(int smem_bytes) {
  if (configure<KERNEL>(smem_bytes) != cudaSuccess) return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, smem_bytes) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

template <auto KERNEL, typename A>
int launch(A a, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = configure<KERNEL>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(KERNEL),
                                    dim3(static_cast<unsigned>(a.cb * a.rb)), dim3(THREADS), params,
                                    static_cast<size_t>(smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The geometry's checks, common to both kernels.
bool bad_geometry(int n_rows, int S, int C, int vec, int tx, int cb, int rb, int rows_per_block,
                  int keep_rows) {
  return n_rows < 1 || S < 1 || n_rows % S || C < 1 || C % vec || tx < 1 || tx > 256 ||
         (tx & (tx - 1)) || cb < 1 || rb < 1 || cb * tx * vec < C ||
         rows_per_block % (THREADS / tx) || static_cast<long long>(rb) * rows_per_block < n_rows ||
         keep_rows < 0;
}

}  // namespace

extern "C" {

// The most blocks a cooperative launch of the (dtype, vec) instantiation
// may have with `smem_bytes` of dynamic shared memory on the current device
// (blocks per SM by the occupancy calculator, times the SMs); -1 on error.
// dtype: 0 float32, 1 bf16; vec: elements per thread per row, 16 bytes' worth
// (4, 8) or 1.
int cond_bn_max_blocks(int dtype, int vec, int smem_bytes) {
  if (dtype == 0 && vec == 4) return max_blocks<cond_bn_kernel<float, 4>>(smem_bytes);
  if (dtype == 0 && vec == 1) return max_blocks<cond_bn_kernel<float, 1>>(smem_bytes);
  if (dtype == 1 && vec == 8) return max_blocks<cond_bn_kernel<__nv_bfloat16, 8>>(smem_bytes);
  if (dtype == 1 && vec == 1) return max_blocks<cond_bn_kernel<__nv_bfloat16, 1>>(smem_bytes);
  return -1;
}

// The same for the backward kernel.
int cond_bn_vjp_max_blocks(int dtype, int vec, int smem_bytes) {
  if (dtype == 0 && vec == 4) return max_blocks<cond_bn_kernel_vjp<float, 4>>(smem_bytes);
  if (dtype == 0 && vec == 1) return max_blocks<cond_bn_kernel_vjp<float, 1>>(smem_bytes);
  if (dtype == 1 && vec == 8) return max_blocks<cond_bn_kernel_vjp<__nv_bfloat16, 8>>(smem_bytes);
  if (dtype == 1 && vec == 1) return max_blocks<cond_bn_kernel_vjp<__nv_bfloat16, 1>>(smem_bytes);
  return -1;
}

// x, out [n_rows, C] of `dtype`, n_rows = B S; labels [B] int32 (label64 0)
// or int64 (1); scale, offset [n_labels, C] float32; stats float32
// [2 + 2 rb, C] (mean, inv, then the partials).  The geometry (vec, tx, cb,
// rb, rows_per_block, keep_rows, smem_bytes) is the caller's, within
// cond_bn_max_blocks.
int cond_bn_forward(const void* x, const void* labels, int label64, const void* scale,
                    const void* offset, void* out, void* stats, int n_rows, int S, int C,
                    int dtype, int vec, int tx, int cb, int rb, int rows_per_block,
                    int keep_rows, int smem_bytes, float eps, int relu, void* stream) {
  if (bad_geometry(n_rows, S, C, vec, tx, cb, rb, rows_per_block, keep_rows))
    return cudaErrorInvalidValue;
  Args a;
  a.x = x, a.labels = labels, a.out = out;
  a.scale = static_cast<const float*>(scale), a.offset = static_cast<const float*>(offset);
  a.stats = static_cast<float*>(stats);
  a.n_rows = n_rows, a.S = S, a.C = C, a.label64 = label64, a.tx = tx, a.cb = cb, a.rb = rb;
  a.rows_per_block = rows_per_block, a.keep_rows = keep_rows, a.eps = eps, a.relu = relu;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<cond_bn_kernel<float, 4>>(a, smem_bytes, st);
  if (dtype == 0 && vec == 1) return launch<cond_bn_kernel<float, 1>>(a, smem_bytes, st);
  if (dtype == 1 && vec == 8) return launch<cond_bn_kernel<__nv_bfloat16, 8>>(a, smem_bytes, st);
  if (dtype == 1 && vec == 1) return launch<cond_bn_kernel<__nv_bfloat16, 1>>(a, smem_bytes, st);
  return cudaErrorInvalidValue;
}

// g, x, out (null without the ReLU), dx (null for no dx) [n_rows, C] of
// `dtype`; labels [B] int32 (label64 0) or int64 (1); scale [n_labels, C],
// mean and inv [C] float32 (the forward's); dscale, doffset [n_labels, C]
// float32, either null for no gradient; work float32 [2 rb + 2 (rb + B -
// 1), C].  The geometry is the caller's, within cond_bn_vjp_max_blocks.
int cond_bn_backward(const void* g, const void* x, const void* out, const void* labels,
                     int label64, const void* scale, const void* mean, const void* inv, void* dx,
                     void* dscale, void* doffset, void* work, int n_rows, int S, int C,
                     int n_labels, int dtype, int vec, int tx, int cb, int rb,
                     int rows_per_block, int keep_rows, int smem_bytes, void* stream) {
  if (bad_geometry(n_rows, S, C, vec, tx, cb, rb, rows_per_block, keep_rows) || n_labels < 1 ||
      static_cast<long long>(n_labels) * C > 0x7fffffff || work == nullptr ||
      (dx == nullptr && dscale == nullptr && doffset == nullptr))
    return cudaErrorInvalidValue;
  VjpArgs a;
  a.g = g, a.x = x, a.out = out, a.labels = labels, a.label64 = label64;
  a.scale = static_cast<const float*>(scale), a.mean = static_cast<const float*>(mean);
  a.inv = static_cast<const float*>(inv), a.dx = dx;
  a.dscale = static_cast<float*>(dscale), a.doffset = static_cast<float*>(doffset);
  a.work = static_cast<float*>(work);
  a.n_rows = n_rows, a.S = S, a.C = C, a.n_labels = n_labels;
  a.tx = tx, a.cb = cb, a.rb = rb, a.rows_per_block = rows_per_block, a.keep_rows = keep_rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<cond_bn_kernel_vjp<float, 4>>(a, smem_bytes, st);
  if (dtype == 0 && vec == 1) return launch<cond_bn_kernel_vjp<float, 1>>(a, smem_bytes, st);
  if (dtype == 1 && vec == 8)
    return launch<cond_bn_kernel_vjp<__nv_bfloat16, 8>>(a, smem_bytes, st);
  if (dtype == 1 && vec == 1)
    return launch<cond_bn_kernel_vjp<__nv_bfloat16, 1>>(a, smem_bytes, st);
  return cudaErrorInvalidValue;
}

const char* cond_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
