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
// Any C: a tensor whose rows are not a whole number of aligned 16-byte
// vectors takes the one-element-per-thread instantiation.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream with cudaLaunchCooperativeKernel, does not synchronise,
// allocates nothing (the caller passes the stats and partials buffer) and
// returns cudaGetLastError().

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

template <typename T, int VEC>
cudaError_t configure(int smem_bytes) {
  static int configured[64] = {0};  // largest dynamic size asked for, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || configured[device] < smem_bytes) {
    err = cudaFuncSetAttribute(cond_bn_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) configured[device] = smem_bytes;
  }
  return cudaSuccess;
}

template <typename T, int VEC>
int max_blocks(int smem_bytes) {
  if (configure<T, VEC>(smem_bytes) != cudaSuccess) return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cond_bn_kernel<T, VEC>, THREADS,
                                                    smem_bytes) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

template <typename T, int VEC>
int launch(Args a, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = configure<T, VEC>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cond_bn_kernel<T, VEC>),
                                    dim3(static_cast<unsigned>(a.cb * a.rb)), dim3(THREADS), params,
                                    static_cast<size_t>(smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most blocks a cooperative launch of the (dtype, vec) instantiation
// may have with `smem_bytes` of dynamic shared memory on the current device
// (blocks per SM by the occupancy calculator, times the SMs); -1 on error.
// dtype: 0 float32, 1 bf16; vec: elements per thread per row, 16 bytes' worth
// (4, 8) or 1.
int cond_bn_max_blocks(int dtype, int vec, int smem_bytes) {
  if (dtype == 0 && vec == 4) return max_blocks<float, 4>(smem_bytes);
  if (dtype == 0 && vec == 1) return max_blocks<float, 1>(smem_bytes);
  if (dtype == 1 && vec == 8) return max_blocks<__nv_bfloat16, 8>(smem_bytes);
  if (dtype == 1 && vec == 1) return max_blocks<__nv_bfloat16, 1>(smem_bytes);
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
  if (n_rows < 1 || S < 1 || n_rows % S || C < 1 || C % vec || tx < 1 || tx > 256 ||
      (tx & (tx - 1)) || cb < 1 || rb < 1 || cb * tx * vec < C ||
      rows_per_block % (THREADS / tx) || static_cast<long long>(rb) * rows_per_block < n_rows ||
      keep_rows < 0)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x, a.labels = labels, a.out = out;
  a.scale = static_cast<const float*>(scale), a.offset = static_cast<const float*>(offset);
  a.stats = static_cast<float*>(stats);
  a.n_rows = n_rows, a.S = S, a.C = C, a.label64 = label64, a.tx = tx, a.cb = cb, a.rb = rb;
  a.rows_per_block = rows_per_block, a.keep_rows = keep_rows, a.eps = eps, a.relu = relu;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(a, smem_bytes, st);
  if (dtype == 0 && vec == 1) return launch<float, 1>(a, smem_bytes, st);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(a, smem_bytes, st);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(a, smem_bytes, st);
  return cudaErrorInvalidValue;
}

const char* cond_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
