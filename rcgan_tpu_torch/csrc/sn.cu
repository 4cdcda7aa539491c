// Spectral norm: one power-iteration step and the W / sigma rescale, float32.
//
// Replaces the Pallas TPU kernel `_kernel` of `sn_fused` (rcgan_tpu/ops/
// pallas/sn_kernel.py), which held W [m, cout] in VMEM once and ran
//     v = l2n(u0 W^T),  u' = l2n(v W),  sigma = (v W) u'^T,  W / sigma
// back to back.  Every spectral-normed layer of the discriminator calls it
// once per D pass (15 per D call plus the projection embedding's).
//
// What bounds it is latency on one SM, neither FLOPs nor bytes.  The chain
// v -> |v| -> u' -> |u'| -> sigma -> W/sigma needs an order across all of W,
// which blocks on the card do not have, so the GEMVs run in one block (below)
// on one of the 132 SMs.  There each warp walks its rows one after another,
// with a 5-step shuffle reduction per row before the next (72 rows per warp
// at m = 1152).  A call takes about 53 us of device time, averaged over the
// 16 weights of a D pass, on an H100 80GB HBM3 at its 700 W power limit,
// while the largest weight on the CIFAR path, 1152 x 128 (590 KB), would
// stream from HBM in well under a microsecond.  The fixes, in order: more
// rows in flight per warp (several rows accumulated before one reduction,
// or lanes split across rows when cout is small), and batching the 16
// weights of a D pass into one launch, a block per weight, so that 16 SMs
// share the latency.  The work is split in two launches:
//
// 1. `sn_power_kernel`, ONE block of 512 threads per weight.  It reads W
//    twice (the second read comes from L2, where the first left it):
//    - v = u0 W^T with one warp per row and the lanes across the row, so a
//      warp reads 128 contiguous bytes at a time;
//    - t = v W with the lanes across a 32-column chunk and the 16 warps
//      across rows, their partials summed in warp order through shared
//      memory;
//    - |v|, |t| and sigma = t . u' as block reductions in a fixed order.
//    The sums therefore come out the same on every run: no atomics.
// 2. `sn_scale_kernel`, a grid over all of W, writes W / sigma, reading
//    sigma from device memory.  This is the pass that moves the most bytes
//    (read W, write W/sigma), so it gets the whole card.
//
// sigma is formed as (v W) u'^T, which is the order in which the jnp
// reference `sn_math` evaluates `v @ w_mat @ u.T`; it saves a third GEMV.
// Any m and any cout >= 1 are taken: ragged columns are masked, and
// cout = 1 (D.Output) or 10 (the perm classifier) leave lanes idle, which
// costs nothing measurable at these sizes.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes
// an [m] float32 scratch for v), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int POWER_THREADS = 512;
constexpr int WARPS = POWER_THREADS / 32;
constexpr int SCALE_THREADS = 256;
constexpr float EPS = 1e-12f;  // added to the norm, as in sn_math

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the sum is in lane 0
}

// Sum over the block of one value per thread: lanes by shuffle, then the
// warps' sums in warp order by thread 0.  Every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
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

__global__ void __launch_bounds__(POWER_THREADS)
sn_power_kernel(const float* __restrict__ w, const float* __restrict__ u0, float* __restrict__ v,
                float* __restrict__ u_new, float* __restrict__ sigma, int m, int cout) {
  __shared__ float red[WARPS + 1];
  __shared__ float part[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // v = u0 W^T: warp per row, lanes across the row.
  float ss = 0.f;
  for (int i = warp; i < m; i += WARPS) {
    const float* row = w + static_cast<size_t>(i) * cout;
    float acc = 0.f;
    for (int j = lane; j < cout; j += 32) acc += row[j] * u0[j];
    acc = warp_sum(acc);
    if (lane == 0) {
      v[i] = acc;
      ss += acc * acc;
    }
  }
  const float vnorm = sqrtf(block_sum(ss, red)) + EPS;  // syncs: v is visible
  for (int i = threadIdx.x; i < m; i += POWER_THREADS) v[i] = v[i] / vnorm;
  __syncthreads();

  // t = v W: lanes across a 32-column chunk, warps across rows; t goes to
  // u_new for now.
  for (int c0 = 0; c0 < cout; c0 += 32) {
    const int j = c0 + lane;
    float acc = 0.f;
    if (j < cout) {
      for (int i = warp; i < m; i += WARPS) acc += v[i] * w[static_cast<size_t>(i) * cout + j];
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && j < cout) {
      float s = 0.f;
      for (int k = 0; k < WARPS; ++k) s += part[k][lane];
      u_new[j] = s;
    }
    __syncthreads();
  }

  // u' = t / |t|, sigma = t . u'.  Each j belongs to one thread in both loops.
  float tt = 0.f;
  for (int j = threadIdx.x; j < cout; j += POWER_THREADS) tt += u_new[j] * u_new[j];
  const float tnorm = sqrtf(block_sum(tt, red)) + EPS;
  float st = 0.f;
  for (int j = threadIdx.x; j < cout; j += POWER_THREADS) {
    const float t = u_new[j];
    const float u = t / tnorm;
    u_new[j] = u;
    st += t * u;
  }
  const float s = block_sum(st, red);
  if (threadIdx.x == 0) *sigma = s;
}

__global__ void __launch_bounds__(SCALE_THREADS)
sn_scale_kernel(const float* __restrict__ w, const float* __restrict__ sigma,
                float* __restrict__ wbar, size_t n) {
  const float s = *sigma;
  const size_t stride = static_cast<size_t>(gridDim.x) * SCALE_THREADS;
  for (size_t i = static_cast<size_t>(blockIdx.x) * SCALE_THREADS + threadIdx.x; i < n;
       i += stride) {
    wbar[i] = w[i] / s;
  }
}

}  // namespace

extern "C" {

// w [m, cout], u0 [cout], v_scratch [m] -> wbar [m, cout], u_new [cout], sigma [1];
// all float32, contiguous, on the device of `stream`.
int sn_f32(const void* w, const void* u0, void* wbar, void* u_new, void* sigma, void* v_scratch,
           int m, int cout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sn_power_kernel<<<1, POWER_THREADS, 0, st>>>(
      static_cast<const float*>(w), static_cast<const float*>(u0), static_cast<float*>(v_scratch),
      static_cast<float*>(u_new), static_cast<float*>(sigma), m, cout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(m) * cout;
  size_t blocks = (n + SCALE_THREADS - 1) / SCALE_THREADS;
  if (blocks > 1024) blocks = 1024;
  sn_scale_kernel<<<static_cast<unsigned>(blocks), SCALE_THREADS, 0, st>>>(
      static_cast<const float*>(w), static_cast<const float*>(sigma), static_cast<float*>(wbar),
      n);
  return static_cast<int>(cudaGetLastError());
}

const char* sn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
