// All-label projection logits: logits[b, l] = wgan[b] + feat[b] . emb[l],
// every input widened to float32 on load, a float32 [B, V] out.
//
// Replaces the Pallas TPU kernel `_kernel` of `all_label_projection_logits`
// (rcgan_tpu/ops/pallas/projection_kernel.py:20), a jnp.dot with float32
// accumulation plus the wgan column, all in VMEM.
//
// What bounds it on the H100 is the launch.  At the CIFAR shapes (feat
// [64, 128], emb [10, 128], wgan [64, 1]) it reads 40 KB and writes 2.5 KB,
// 0.012 us at 3.35 TB/s, and does 0.16 MFLOP.  So the design is one launch
// with nothing around it, and a wrapper (ops/kernels/projection_kernel.py)
// that keeps the host's cost of issuing it small:
//
// - one block of 8 warps per 8 rows of feat; each block stages the whole of
//   emb in shared memory as float32 (V*D*4 bytes, 5 KB here, at most 48 KB);
// - one warp per row: each lane reads 8 consecutive values of the row as one
//   16-byte vector (two for float32) and widens them on load.  Each input's
//   type is its own (float32, bf16 or fp16; the rcgan-u path passes all
//   bf16 in bf16 training and all float32 in float32);
// - each lane sums its products for every label with float32 FMAs (no TF32,
//   no reduced precision), the warp adds its lanes' sums by shuffles in a
//   fixed order, and wgan is added in the epilogue.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a call it does not take).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };  // the wrapper's codes

constexpr int WARPS = 8;    // rows of feat per block
constexpr int LABELS = 16;  // labels a lane sums at once
constexpr int MAX_EMB = 12288;  // floats of emb in 48 KB of shared memory

bool known(int dtype) { return dtype == F32 || dtype == BF16 || dtype == F16; }

__device__ __forceinline__ float widen16(unsigned short h, int dtype) {
  if (dtype == BF16) return __uint_as_float(static_cast<unsigned>(h) << 16);
  return __half2float(__ushort_as_half(h));
}

__device__ __forceinline__ float widen(const void* p, int dtype, int i) {
  if (dtype == F32) return static_cast<const float*>(p)[i];
  return widen16(static_cast<const unsigned short*>(p)[i], dtype);
}

// v[0..7] = p[i..i+7] as float32; p + i is 16-byte aligned
__device__ __forceinline__ void widen8(const void* p, int dtype, int i, float v[8]) {
  if (dtype == F32) {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(p) + i);
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = widen16(static_cast<unsigned short>(words[k] & 0xffffu), dtype);
    v[2 * k + 1] = widen16(static_cast<unsigned short>(words[k] >> 16), dtype);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
projection_kernel(const void* __restrict__ feat, int feat_t, const void* __restrict__ emb,
                  int emb_t, const void* __restrict__ wgan, int wgan_t, float* __restrict__ out,
                  int B, int V, int D) {
  extern __shared__ __align__(16) float emb_s[];  // [V, D]
  for (int i = threadIdx.x; i < V * D; i += blockDim.x) emb_s[i] = widen(emb, emb_t, i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // a whole warp leaves: the shuffles below see full warps
  const float wg = widen(wgan, wgan_t, row);
  for (int l0 = 0; l0 < V; l0 += LABELS) {
    float acc[LABELS];
#pragma unroll
    for (int l = 0; l < LABELS; ++l) acc[l] = 0.f;
    for (int d = lane * 8; d < D; d += 32 * 8) {
      float f[8];
      widen8(feat, feat_t, row * D + d, f);
#pragma unroll
      for (int l = 0; l < LABELS; ++l) {
        if (l0 + l >= V) continue;  // (not break: acc stays in registers)
        const float4* e = reinterpret_cast<const float4*>(emb_s + (l0 + l) * D + d);
        const float4 e0 = e[0];
        const float4 e1 = e[1];
        float s = acc[l];
        s = fmaf(f[0], e0.x, s);
        s = fmaf(f[1], e0.y, s);
        s = fmaf(f[2], e0.z, s);
        s = fmaf(f[3], e0.w, s);
        s = fmaf(f[4], e1.x, s);
        s = fmaf(f[5], e1.y, s);
        s = fmaf(f[6], e1.z, s);
        s = fmaf(f[7], e1.w, s);
        acc[l] = s;
      }
    }
#pragma unroll
    for (int l = 0; l < LABELS; ++l) {
      if (l0 + l >= V) continue;
      float s = acc[l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == l) out[row * V + l0 + l] = s + wg;
    }
  }
}

}  // namespace

extern "C" {

// feat [B, D], emb [V, D], wgan [B, 1], each of type code *_t (0 float32,
// 1 bf16, 2 fp16), contiguous, feat 16-byte aligned; D a multiple of 8,
// V*D <= 12288; out float32 [B, V].
int projection_logits(const void* feat, int feat_t, const void* emb, int emb_t,
                      const void* wgan, int wgan_t, void* out, int B, int V, int D,
                      void* stream) {
  if (B < 1 || V < 1 || D < 8 || D % 8 || V * D > MAX_EMB || !known(feat_t) || !known(emb_t) ||
      !known(wgan_t))
    return cudaErrorInvalidValue;
  projection_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, V * D * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      feat, feat_t, emb, emb_t, wgan, wgan_t, static_cast<float*>(out), B, V, D);
  return static_cast<int>(cudaGetLastError());
}

const char* projection_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
