// 3x3, stride 1, SAME convolution, NHWC x HWIO -> NHWC, float32 accumulation.
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (rcgan_tpu/ops/pallas/
// conv_kernel.py), which summed nine shifted-tap products [B*H*W, C] x [C, O]
// over a zero-padded copy of the input held in VMEM.
//
// Here the same sum is one implicit GEMM: M = B*H*W output pixels,
// N = O output channels, K = 9*C (tap-major, channel-minor, which is the
// row order of the HWIO filter seen as a [9*C, O] matrix).  What bounds it on
// the H100 is arithmetic: at the generator's shapes it does 150-1200 FMAs per
// byte it reads, far above the card's balance point, so the design spends its
// effort on reuse.  Each block computes a 128 x 64 output tile; it stages a
// 128 x 16 slice of the implicit input matrix and a 16 x 64 slice of the
// filter in shared memory per K step, and each of its 256 threads keeps an
// 8 x 4 tile of f32 accumulators in registers, so every shared-memory load
// feeds 2.7 FMAs.  The halo is handled by bounds checks while staging (no
// padded copy), and ragged M, C and O are masked, so every 3x3/s1/SAME call
// is in the kernel's class, including the generator's 256 -> 3 output conv.
//
// This first version runs on the CUDA cores (FFMA).  Tensor cores (mma.sync,
// wgmma) and TMA loads are left for later work.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 16;         // K (tap x channel) per step
constexpr int TM = 8;          // pixels per thread
constexpr int TN = 4;          // channels per thread
constexpr int THREADS = 256;   // (BM / TM) * (BN / TN)
constexpr int A_PAD = 4;       // keeps float4 rows aligned, spreads banks

static_assert((BM / TM) * (BN / TN) == THREADS, "thread tiling");
static_assert(BM * BK == THREADS * 8, "A staging: 8 values per thread");
static_assert(BK * BN == THREADS * 4, "B staging: 4 values per thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    int B, int H, int W, int C, int O) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];  // [k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // [k][n]

  const int M = B * H * W;
  const int K = 9 * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // Staging roles.  A: each thread fetches 8 consecutive k (channels, in
  // NHWC order) of one output pixel.  B: 4 consecutive output channels of
  // one filter row.
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const int gm = m0 + a_m;
  const bool m_ok = gm < M;
  int pb = 0, py = 0, px = 0;
  if (m_ok) {
    pb = gm / (H * W);
    const int r = gm - pb * H * W;
    py = r / W;
    px = r - py * W;
  }
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;

  // Compute roles: thread (ty, tx) owns pixels ty*TM.. and channels tx*TN..
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      int k = k0 + a_k;
      int tap = k / C;
      int c = k - tap * C;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = 0.f;
        if (m_ok && tap < 9) {
          const int iy = py + tap / 3 - 1;
          const int ix = px + tap % 3 - 1;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            v = to_f32(x[((pb * H + iy) * W + ix) * C + c]);
        }
        As[a_k + i][a_m] = v;
        if (++c == C) {
          c = 0;
          ++tap;
        }
      }
    }
    {
      const int k = k0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_n + j;
        Bs[b_k][b_n + j] = (k < K && n < O) ? to_f32(w[k * O + n]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < O) y[m * O + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
           void* stream) {
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  conv3x3_nhwc_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), B, H, W, C, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv3x3_nhwc_f32(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
                     void* stream) {
  return launch<float>(x, w, y, B, H, W, C, O, stream);
}

int conv3x3_nhwc_bf16(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
                      void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, H, W, C, O, stream);
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
