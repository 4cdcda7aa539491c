// 3x3, stride 1, SAME convolution on Hopper's tensor cores: bf16 NHWC x HWIO
// -> bf16 NHWC, float32 accumulation rounded once.
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (rcgan_tpu/ops/pallas/
// conv_kernel.py:101), which summed nine shifted-tap products
// [B*H*W, C] x [C, O] over a zero-padded copy of the input held in VMEM.
//
// What bounds it on the H100 is arithmetic.  One rcgan training cycle at
// batch 64 runs 174 of these convs (forwards and input grads), 2.88 TFLOP:
// 2.92 ms at the card's 989 TFLOP/s bf16 peak against 1.00 ms for their
// 3.37 GB read and written once.  The largest, 32x32 maps 256 -> 256 at batch 128,
// is 154.6 GFLOP, 156 us at peak.  Only `wgmma` reaches that rate, so this
// kernel is built around it:
//
// - Implicit GEMM, M = B*H*W output pixels, N = O, K = 9*C tap-major, as the
//   FFMA kernel (conv3x3.cu).  One K step is one tap (dy, dx) times 64
//   channels: 9*C/64 steps.
// - Operand A comes through TMA, padding included.  A 4-D tensor map over x
//   (dims C, W, H, B) with box [64 ch, W, rows, imgs], imgs*rows*W = BM,
//   is loaded at origin (c0, dx-1, y0+dy-1, b0).  TMA fills coordinates
//   outside the tensor, negative ones included, with zeros: that is SAME
//   padding, with no halo code and no padded copy.  The box lands as a
//   K-major [BM x 64] bf16 tile in the 128-byte swizzle that wgmma reads.
// - Operand B comes through TMA too: the HWIO filter seen as [9C, O], O
//   contiguous, is an MN-major B, which wgmma takes for bf16 with its
//   transpose bit.  Two boxes of [64 k x 64 n] per stage, so the filter
//   needs no transposed copy.
// - A ring of STAGES stages in dynamic shared memory, handed off through
//   mbarriers: one producer warp issues the loads with expect_tx, and one
//   or two consumer warpgroups (BM = 64 or 128) issue m64nBNk16 wgmmas
//   (BN = 128 or 256 output channels) with float32 accumulators in
//   registers, keep one group in flight (wgmma.wait_group 1) and release
//   each stage when its group is done.
// - Epilogue: each accumulator rounded to bf16 and stored NHWC straight
//   from registers, masked at the edge of M and of N.
// - The wrapper (ops/kernels/conv_kernel.py) picks the tile and computes
//   the box geometry: 128 x 256 where O is a multiple of 256 and that tile
//   still gives most of a wave of blocks (it halves the A loads per output,
//   and the 256-wide wgmma runs the tensor cores longer per stage), else
//   64 x 128 where 128 x 128 would leave fewer blocks than the card's 132
//   SMs, else 128 x 128.  Only bf16 with C and O multiples of 64 and maps
//   whose H*W divides BM or is divided by it come here.
//
// The tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint so the
// library links the CUDA runtime only, and passed as __grid_constant__
// kernel parameters.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns 0 or
// an error code that conv3x3_wgmma_error_string explains.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BK = 64;                        // channels per K step: one 128-byte row
constexpr int STAGES = 4;
constexpr int ROW_BYTES = BK * 2;             // 128, the swizzle width
constexpr int B_BOX_BYTES = BK * 64 * 2;      // one [64 k x 64 n] filter box

constexpr int ERR_NO_ENCODE = 900001;         // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 910000;            // + CUresult of a refused encode

// BM output pixels x BN output channels per block
template <int BM, int BN>
struct Cfg {
  static constexpr int NWG = BM / 64;                 // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;      // + the producer warp
  static constexpr int A_STAGE_BYTES = BM * ROW_BYTES;
  static constexpr int B_STAGE_BYTES = (BN / 64) * B_BOX_BYTES;
  static constexpr int STAGE_BYTES = A_STAGE_BYTES + B_STAGE_BYTES;
  // stages, then 2*STAGES mbarriers, plus slack to align the ring to 1024
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A K-major, B MN-major (the
// transpose bit, the last immediate, set).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 1;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], as above.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 1;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b));
}

// The instruction for a tile BN = 2 * (accumulators per thread) wide.
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_m64n128k16(d, a, b);
}
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[128], uint64_t a, uint64_t b) {
  wgmma_m64n256k16(d, a, b);
}

template <int BM, int BN>
__global__ void __launch_bounds__(Cfg<BM, BN>::THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map, __nv_bfloat16* __restrict__ y,
                     int H, int W, int C, int O, int M) {
  using K = Cfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle wants 1024
  const uint32_t bars = ring + STAGES * K::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int m0 = blockIdx.x * BM;  // M tiles on x: up to 2^31 - 1 of them
  const int n0 = blockIdx.y * BN;
  const int k_chunks = C / BK;
  const int k_steps = 9 * k_chunks;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), K::NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == K::NWG * 4) {
    // ---- producer: one thread keeps up to STAGES steps of loads in flight
    if (threadIdx.x % 32 == 0) {
      const int hw = H * W;
      const int b0 = m0 / hw;
      const int y0 = (m0 - b0 * hw) / W;
      for (int k = 0; k < k_steps; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(empty(s), ((k / STAGES) - 1) & 1);
        const uint32_t a_dst = ring + s * K::STAGE_BYTES;
        const uint32_t b_dst = a_dst + K::A_STAGE_BYTES;
        mbar_expect_tx(full(s), K::STAGE_BYTES);
        const int tap = k / k_chunks;
        const int c0 = (k - tap * k_chunks) * BK;
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        tma_load_4d(a_dst, &x_map, full(s), c0, dx - 1, y0 + dy - 1, b0);
        const int krow = tap * C + c0;  // filter as [9C, O]: BN/64 [64 k x 64 n] boxes
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_2d(b_dst + h * B_BOX_BYTES, &w_map, full(s), n0 + 64 * h, krow);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
    const int wg = warp / 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < k_steps; ++k) {
      const int s = k % STAGES;
      mbar_wait(full(s), (k / STAGES) & 1);
      const uint32_t a_tile = ring + s * K::STAGE_BYTES + wg * 64 * ROW_BYTES;
      const uint32_t b_tile = ring + s * K::STAGE_BYTES + K::A_STAGE_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 8-row groups 1024 bytes apart; 16 k = 32 bytes along the row
        const uint64_t a = desc_sw128(a_tile + kk * 32, 16, 1024);
        // B: the 64-wide n boxes B_BOX_BYTES apart (LBO), 8-row k groups
        // 1024 apart (SBO); 16 k = 16 rows of 128 bytes
        const uint64_t b = desc_sw128(b_tile + kk * 16 * ROW_BYTES, B_BOX_BYTES, 1024);
        wgmma_m64nk16(acc, a, b);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (k > 0) mbar_arrive(empty((k - 1) % STAGES));  // step k-1's group is done
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);

    // accumulator layout of m64nNk16: warp w of the group holds rows
    // 16w + lane/4 (+8); register 4i + 2j + c is column 8i + 2*(lane%4) + c
    // of row half j
    const int t = threadIdx.x % 128;
    const int row0 = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col0 = n0 + (t % 4) * 2;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = row0 + 8 * j;
        const int n = col0 + 8 * i;
        if (m < M && n < O) {
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m) * O + n) =
              __floats2bfloat162_rn(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

CUresult encode(EncodeTiledFn enc, CUtensorMap* map, int rank, const void* ptr,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raises the kernel's dynamic shared memory limit, once per device.
template <int BM, int BN>
cudaError_t allow_smem(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<BM, BN>::SMEM_BYTES);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int BM, int BN>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int O, int rows,
           int imgs, cudaStream_t stream) {
  using K = Cfg<BM, BN>;
  static const EncodeTiledFn enc = lookup_encode();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
  const cuuint32_t x_box[4] = {BK, (cuuint32_t)W, (cuuint32_t)rows, (cuuint32_t)imgs};
  CUresult r = encode(enc, &x_map, 4, x, x_dims, x_strides, x_box);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  const cuuint64_t w_dims[2] = {(cuuint64_t)O, 9 * (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {O * e};
  const cuuint32_t w_box[2] = {64, BK};
  r = encode(enc, &w_map, 2, w, w_dims, w_strides, w_box);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);

  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = allow_smem<BM, BN>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  conv3x3_wgmma_kernel<BM, BN><<<grid, K::THREADS, K::SMEM_BYTES, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(y), H, W, C, O, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [B,H,W,C], w [3,3,C,O], y [B,H,W,O], bf16.  Tiles (bm, bn) of (64, 128),
// (128, 128) or (128, 256); the x box is [64, W, rows, imgs] with
// imgs*rows*W == bm.
int conv3x3_wgmma_bf16(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
                       int bm, int bn, int rows, int imgs, void* stream) {
  if (C % BK != 0 || O % 64 != 0 || imgs * rows * W != bm) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 128) return launch<64, 128>(x, w, y, B, H, W, C, O, rows, imgs, st);
  if (bm == 128 && bn == 128) return launch<128, 128>(x, w, y, B, H, W, C, O, rows, imgs, st);
  if (bm == 128 && bn == 256) return launch<128, 256>(x, w, y, B, H, W, C, O, rows, imgs, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a block of tile (bm, bn) asks for (ptxas -v reports
// static shared memory only); -1 for a tile that is not built.
int conv3x3_wgmma_smem_bytes(int bm, int bn) {
  if (bm == 64 && bn == 128) return Cfg<64, 128>::SMEM_BYTES;
  if (bm == 128 && bn == 128) return Cfg<128, 128>::SMEM_BYTES;
  if (bm == 128 && bn == 256) return Cfg<128, 256>::SMEM_BYTES;
  return -1;
}

const char* conv3x3_wgmma_error_string(int code) {
  static thread_local char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found through the runtime";
  if (code >= ERR_ENCODE && code < ERR_ENCODE + 10000) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused the tensor map (CUresult %d)",
             code - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
