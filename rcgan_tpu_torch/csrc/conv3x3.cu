// 3x3, stride 1, SAME convolution on the CUDA cores (FFMA): NHWC x HWIO ->
// NHWC, float32 accumulation, output in the input type (float32 or bf16).
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (rcgan_tpu/ops/pallas/
// conv_kernel.py:77), which summed nine shifted-tap products [B*H*W, C] x
// [C, O] over a zero-padded copy of the input held in VMEM.  Its class here
// is C and O multiples of 64 (the TPU kernel's is multiples of 128); the
// wrapper (ops/kernels/conv_kernel.py) sends bf16 calls whose maps tile by
// 128 pixels to the tensor-core kernel (conv3x3_wgmma.cu) and other channel
// counts to cuDNN.  What comes here is float32, which serving pins in full
// (TF32 would keep three digits), and bf16 calls whose maps do not tile.
//
// What bounds it on the H100 is operations: a float32 generator pass at
// batch 100 runs six of these convs, 340 GFLOP, 5.07 ms at the card's 67
// TFLOP/s float32 peak against 0.2 ms for their bytes.  So the design is
// about keeping the FMA pipes fed:
//
// - Implicit GEMM, M = B*H*W output pixels, N = O, K = 9*C tap-major,
//   channel-minor (the row order of the HWIO filter seen as [9C, O]).  A K
//   step is BK = 32 (or 16) channels of one tap, since C is a multiple of
//   64: the tap, the pixel offsets and the halo test are worked out once per
//   pixel per step, not per value.
// - Both operands move as 16-byte cp.async copies into shared memory, with
//   no staging through registers: a row of A (BK channels of one input
//   pixel) and a row of B (BN filter columns).  A halo pixel is a zero-fill
//   copy (src-size 0), so there is no padded copy of the input.
// - The copies run through a ring of 3 (or 4) stages (cp.async.commit_group
//   / wait_group), so the loads of step t+2 overlap the FMAs of step t, with
//   one __syncthreads per step.
// - A 128 x 128 tile for 256 threads, each keeping 8 x 8 float32
//   accumulators as four 4 x 4 quadrants 64 apart.  Per 4 K values a thread
//   reads 8 A vectors (4 K values of one pixel, float4) and 8 B vectors (4
//   channels, float4): 16 shared loads for 256 FMAs.  Within a quarter-warp
//   the A reads are one address (a broadcast) and the B reads 128
//   contiguous bytes, so neither conflicts on the banks.
// - The epilogue goes through shared memory: the accumulators are written
//   as a float tile, then read back row-wise and stored as 16-byte vectors.
// - Where the grid would leave SMs idle (small batches), the wrapper's
//   geometry first shrinks the tile: 64 x 64 (64 threads, 8 x 8 each), then
//   32 x 32 and 16 x 16 (64 and 16 threads, 4 x 4 each), BK 16, 4 stages.
//   Every tile sums each output as one chain of FMAs over k in order, so a
//   smaller tile changes no result.  Only where even 16 x 16 tiles are
//   fewer than the SMs (on the CIFAR shapes, batches of four or fewer) does
//   it split K over the grid's z, on 64 x 64 tiles: each split sums whole K
//   steps into a float32 workspace slice, and a second pass adds the slices
//   in a fixed order and casts to the output type (deterministic, no
//   atomics).  Splitting changes the order of the sum, and so the last bits
//   of a result; the float32 training checks, whose gradients are
//   ill-conditioned, run at batches that the tiles alone fill.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a call it does not take)
// so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A tile of BM output pixels x BN output channels, TM x TN of them a thread
// (8 x 8 or 4 x 4), K steps of BK channels through STAGES stages.
template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES>
struct Cfg {
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int A_LD = BK + VEC;       // A row pitch: 16 bytes of pad per row
  static constexpr int A_ELEMS = BM * A_LD;   // [BM pixels][BK channels]
  static constexpr int B_ELEMS = BK * BN;     // [BK k][BN channels]
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int OUT_BYTES = BM * BN * 4;  // the epilogue's float tile
  static constexpr int SMEM_BYTES = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;
  // staging: each thread copies one 16-byte column of A_PASSES rows of A
  // and of B_PASSES rows of B per step
  static constexpr int A_CPR = BK / VEC;
  static constexpr int A_ROWS = THREADS / A_CPR;
  static constexpr int A_PASSES = BM / A_ROWS;
  static constexpr int B_CPR = BN / VEC;
  static constexpr int B_ROWS = THREADS / B_CPR;
  static constexpr int B_PASSES = BK / B_ROWS;
  static_assert(THREADS % A_CPR == 0 && BM % A_ROWS == 0, "A staging");
  static_assert(THREADS % B_CPR == 0 && BK % B_ROWS == 0, "B staging");
  static_assert(BK % 4 == 0 && (TM == 4 || TM == 8) && (TN == 4 || TN == 8), "thread tiling");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = copy ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive values as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // a bf16 is a float32's high half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// 16 bytes of output from float32 values
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                                              pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
}

// Tile row (or column) that accumulator row i of thread row t holds: runs of
// four, in two quadrants BM/2 apart when a thread holds eight.
template <int BM, int TM>
__device__ __forceinline__ int acc_row(int t, int i) {
  return (TM == 8 && i >= 4 ? BM / 2 : 0) + t * 4 + (i & 3);
}

// One block: output pixels m0.. (BM) x channels n0.. (BN), K steps of split
// blockIdx.z, written to out + blockIdx.z * M * O (y itself when unsplit).
// Unsplit, each output is one chain of fmaf over k = 0 .. 9C-1 in order,
// whatever the tile, so the tile never changes a result.
template <typename T, typename OutT, int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__(Cfg<T, BM, BN, TM, TN, BK, STAGES>::THREADS)
conv3x3_ffma_kernel(const T* __restrict__ x, const T* __restrict__ w, OutT* __restrict__ out,
                    int H, int W, int C, int O, int M, int splits) {
  using K = Cfg<T, BM, BN, TM, TN, BK, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const pipe = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = 9 * C / BK;
  const int s_begin = static_cast<int>((long long)blockIdx.z * steps / splits);
  const int nsteps = static_cast<int>((long long)(blockIdx.z + 1) * steps / splits) - s_begin;

  // A staging: this thread's rows, their output pixel (or -1 past M) and
  // its (y, x), worked out once
  const int a_col = (tid % K::A_CPR) * K::VEC;
  const int a_row0 = tid / K::A_CPR;
  int a_m[K::A_PASSES];
  int a_y[K::A_PASSES];
  int a_x[K::A_PASSES];
#pragma unroll
  for (int p = 0; p < K::A_PASSES; ++p) {
    const int m = m0 + a_row0 + p * K::A_ROWS;
    const int r = m % (H * W);
    a_m[p] = m < M ? m : -1;
    a_y[p] = r / W;
    a_x[p] = r - a_y[p] * W;
  }
  // B staging: one 16-byte column of the filter rows
  const int b_col = (tid % K::B_CPR) * K::VEC;
  const int b_row0 = tid / K::B_CPR;
  const bool b_ok = n0 + b_col < O;

  auto load_stage = [&](int stage, int step) {
    T* As = pipe + stage * K::STAGE_ELEMS;
    T* Bs = As + K::A_ELEMS;
    const int k0 = step * BK;  // the step's first row of the [9C, O] filter
    const int tap = k0 / C;
    const int c0 = k0 - tap * C + a_col;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int p = 0; p < K::A_PASSES; ++p) {
      const int iy = a_y[p] + dy;
      const int ix = a_x[p] + dx;
      const bool ok = a_m[p] >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const T* src = ok ? x + (a_m[p] + dy * W + dx) * C + c0 : x;
      cp_async16(As + (a_row0 + p * K::A_ROWS) * K::A_LD + a_col, src, ok);
    }
#pragma unroll
    for (int p = 0; p < K::B_PASSES; ++p) {
      const int k = b_row0 + p * K::B_ROWS;
      const T* src = b_ok ? w + (k0 + k) * O + n0 + b_col : w;
      cp_async16(Bs + k * BN + b_col, src, b_ok);
    }
  };

  // compute roles: thread (ty, tx) owns rows acc_row<BM, TM>(ty, 0..TM-1)
  // and channels acc_row<BN, TN>(tx, 0..TN-1)
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s_begin + s);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();  // step t's copies have landed ...
    __syncthreads();              // ... for every thread, and step t-1's stage is free
    if (t + STAGES - 1 < nsteps) load_stage((t + STAGES - 1) % STAGES, s_begin + t + STAGES - 1);
    cp_async_commit();

    const T* As = pipe + (t % STAGES) * K::STAGE_ELEMS;
    const T* Bs = As + K::A_ELEMS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = load4(As + acc_row<BM, TM>(ty, i) * K::A_LD + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int jq = 0; jq < TN; jq += 4) {
          const float4 v = load4(Bs + (kq + kk) * BN + acc_row<BN, TN>(tx, jq));
          b[jq] = v.x;
          b[jq + 1] = v.y;
          b[jq + 2] = v.z;
          b[jq + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue's tile

  float* Cs = reinterpret_cast<float*>(smem);  // [BM][BN]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* row = Cs + acc_row<BM, TM>(ty, i) * BN;
#pragma unroll
    for (int jq = 0; jq < TN; jq += 4)
      *reinterpret_cast<float4*>(row + acc_row<BN, TN>(tx, jq)) =
          make_float4(acc[i][jq], acc[i][jq + 1], acc[i][jq + 2], acc[i][jq + 3]);
  }
  __syncthreads();
  constexpr int OV = 16 / sizeof(OutT);  // output values per 16-byte store
  constexpr int CPR = BN / OV;
  OutT* const dst = out + (long long)blockIdx.z * M * O;
  for (int q = tid; q < BM * CPR; q += K::THREADS) {
    const int r = q / CPR;
    const int c = (q - r * CPR) * OV;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < O) store16(dst + (long long)m * O + n, Cs + r * BN + c);
  }
}

// y = sum over the splits' float32 slices of ws, in split order, 4 values
// a thread.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

template <typename T>
__global__ void splitk_sum_kernel(const float* __restrict__ ws, T* __restrict__ y, int splits,
                                  long long mo) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= mo) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + z * mo + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  store4(y + i, s);
}

template <typename T, typename OutT, int BM, int BN, int TM, int TN, int BK, int STAGES>
cudaError_t launch_tile(const T* x, const T* w, OutT* out, int B, int H, int W, int C, int O,
                        int splits, cudaStream_t stream) {
  using K = Cfg<T, BM, BN, TM, TN, BK, STAGES>;
  auto kernel = conv3x3_ffma_kernel<T, OutT, BM, BN, TM, TN, BK, STAGES>;
  // raise the kernel's dynamic shared memory limit, once per device
  static bool done[64] = {};
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || !done[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) done[device] = true;
  }
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN, splits);
  kernel<<<grid, K::THREADS, K::SMEM_BYTES, stream>>>(x, w, out, H, W, C, O, M, splits);
  return cudaGetLastError();
}

// The tiles the wrapper's ffma_geometry picks: 128 x 128 (8 x 8 a thread,
// BK 32, 3 stages), 64 x 64 (8 x 8, BK 16, 4 stages), 32 x 32 or 16 x 16
// (4 x 4, BK 16, 4 stages), all unsplit; or 64 x 64 split over `splits`
// slices of K into ws, then summed into y.
template <typename T>
int launch(const void* x_, const void* w_, void* y_, void* ws, int B, int H, int W, int C,
           int O, int bm, int bn, int splits, void* stream_) {
  if (C % 64 || O % 64 || B < 1 || H < 1 || W < 1 || splits < 1 || bm != bn)
    return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* y = static_cast<T*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (splits == 1) {
    if (bm == 128) return launch_tile<T, T, 128, 128, 8, 8, 32, 3>(x, w, y, B, H, W, C, O, 1, stream);
    if (bm == 64) return launch_tile<T, T, 64, 64, 8, 8, 16, 4>(x, w, y, B, H, W, C, O, 1, stream);
    if (bm == 32) return launch_tile<T, T, 32, 32, 4, 4, 16, 4>(x, w, y, B, H, W, C, O, 1, stream);
    if (bm == 16) return launch_tile<T, T, 16, 16, 4, 4, 16, 4>(x, w, y, B, H, W, C, O, 1, stream);
    return cudaErrorInvalidValue;
  }
  if (bm != 64 || splits > 9 * C / 16 || ws == nullptr) return cudaErrorInvalidValue;
  float* part = static_cast<float*>(ws);
  cudaError_t err =
      launch_tile<T, float, 64, 64, 8, 8, 16, 4>(x, w, part, B, H, W, C, O, splits, stream);
  if (err != cudaSuccess) return err;
  const long long mo = (long long)B * H * W * O;  // a multiple of 64
  const long long blocks = (mo / 4 + 255) / 256;
  splitk_sum_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, y, splits, mo);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block of tile (bm, bm); -1 for a tile not built.
template <typename T>
int smem_bytes(int bm) {
  if (bm == 128) return Cfg<T, 128, 128, 8, 8, 32, 3>::SMEM_BYTES;
  if (bm == 64) return Cfg<T, 64, 64, 8, 8, 16, 4>::SMEM_BYTES;
  if (bm == 32) return Cfg<T, 32, 32, 4, 4, 16, 4>::SMEM_BYTES;
  if (bm == 16) return Cfg<T, 16, 16, 4, 4, 16, 4>::SMEM_BYTES;
  return -1;
}

}  // namespace

extern "C" {

// x [B,H,W,C], w [3,3,C,O], y [B,H,W,O], all 16-byte aligned; C and O
// multiples of 64; ws: float32 [splits, B*H*W, O] when splits > 1, else
// unused.
int conv3x3_ffma_f32(const void* x, const void* w, void* y, void* ws, int B, int H, int W, int C,
                     int O, int bm, int bn, int splits, void* stream) {
  return launch<float>(x, w, y, ws, B, H, W, C, O, bm, bn, splits, stream);
}

int conv3x3_ffma_bf16(const void* x, const void* w, void* y, void* ws, int B, int H, int W, int C,
                      int O, int bm, int bn, int splits, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, ws, B, H, W, C, O, bm, bn, splits, stream);
}

// Dynamic shared memory a block of tile (bm, bm) asks for, for inputs of
// `itemsize` bytes (ptxas -v reports static shared memory only); -1 for a
// tile that is not built.
int conv3x3_ffma_smem_bytes(int bm, int itemsize) {
  if (itemsize == 4) return smem_bytes<float>(bm);
  if (itemsize == 2) return smem_bytes<__nv_bfloat16>(bm);
  return -1;
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
