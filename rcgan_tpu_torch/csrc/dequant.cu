// CIFAR dequantisation: uint8 CHW-flat rows -> float32 HWC-flat rows,
// out = 2 (x / 256 - 0.5) + u with u in [0, 1/128) from the row's seed.
//
// Replaces the Pallas TPU kernel `_kernel` of `dequantize_chw_flat` /
// `dequantize_fused` (rcgan_tpu/ops/pallas/dequant_kernel.py:51), which drew
// u from the TPU's on-core PRNG seeded per row and wrote the HWC order.
//
// At the training shape ([64, 3072]: 196 608 bytes in, 786 432 out) the work
// is far below what the card needs to be busy: its bound is well under a
// microsecond, so the launch and the host's cost of issuing it are what the
// design has to keep small.  What it does:
//
// - one thread owns 4 pixels of one row: it reads the C channel planes as C
//   `uchar4` loads (consecutive threads, consecutive words: coalesced) and
//   writes the 4*C HWC outputs as C `float4` stores to 4*C contiguous floats
//   (offset 4*C*p0 floats, 16-byte aligned since p0 is a multiple of 4), so
//   every access is coalesced and no transpose pass is needed;
// - a 2-D grid (row, chunk of 128 threads): at batch 64 and 1 024 pixels a
//   row that is 128 blocks, about one per SM of an H100;
// - the noise is a counter-based hash, splitmix64 as in core/rng.py:
//   h = mix(mix(seed_row) ^ mix(chw)) and u = (h >> 40) * 2^-24 / 128, so
//   u < 1/128 strictly and a row depends only on its own seed and the CHW
//   offset (the TPU kernel's layout invariance);
// - every float operation is rounded on its own (__fmul_rn, __fadd_rn), so
//   no FMA contraction can change a bit: the kernel and its plain version
//   (ops/kernels/dequant_kernel.py::dequantize_plain with row_noise, int64
//   tensor ops) agree bit for bit.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a call it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads per block, 4 pixels each

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// 2 (x / 256 - 0.5) + u, each step rounded on its own as the plain version
// computes it in float32 tensor ops
__device__ __forceinline__ float dequant(unsigned char x, uint64_t base, uint64_t chw) {
  const uint64_t h = mix(base ^ mix(chw));
  const float u = __fmul_rn(static_cast<float>(static_cast<uint32_t>(h >> 40)),
                            4.656612873077393e-10f);  // 2^-31 = 2^-24 / 128
  const float v = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(static_cast<float>(x), 0.00390625f), 0.5f));
  return __fadd_rn(v, u);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const unsigned char* __restrict__ x, const int* __restrict__ seeds,
               float* __restrict__ out, int hw) {
  const int row = blockIdx.x;
  const int p0 = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (p0 >= hw) return;
  const int64_t d = static_cast<int64_t>(hw) * C;
  // the int32 seed widened with its sign, as the plain version's int64 cast
  const uint64_t base = mix(static_cast<uint64_t>(static_cast<int64_t>(seeds[row])));
  const unsigned char* xr = x + row * d;
  float v[4 * C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(xr + static_cast<int64_t>(c) * hw + p0);
    const uint64_t chw = static_cast<uint64_t>(c) * hw + p0;
    v[0 * C + c] = dequant(q.x, base, chw);
    v[1 * C + c] = dequant(q.y, base, chw + 1);
    v[2 * C + c] = dequant(q.z, base, chw + 2);
    v[3 * C + c] = dequant(q.w, base, chw + 3);
  }
  float4* o = reinterpret_cast<float4*>(out + row * d + static_cast<int64_t>(p0) * C);
#pragma unroll
  for (int k = 0; k < C; ++k) o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int C>
void launch(const void* x, const void* seeds, void* out, int rows, int hw, cudaStream_t stream) {
  const dim3 grid(rows, (hw / 4 + THREADS - 1) / THREADS);
  dequant_kernel<C><<<grid, THREADS, 0, stream>>>(static_cast<const unsigned char*>(x),
                                                  static_cast<const int*>(seeds),
                                                  static_cast<float*>(out), hw);
}

}  // namespace

extern "C" {

// x uint8 [rows, C*hw] CHW-flat, 4-byte aligned; seeds int32 [rows]; out
// float32 [rows, hw*C] HWC-flat, 16-byte aligned; hw a multiple of 4,
// 1 <= C <= 4, rows < 2^31.
int dequant_chw_to_hwc(const void* x, const void* seeds, void* out, int rows, int hw, int c,
                       void* stream) {
  if (rows < 1 || hw < 4 || hw % 4 || (hw / 4 + THREADS - 1) / THREADS > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch<1>(x, seeds, out, rows, hw, s); break;
    case 2: launch<2>(x, seeds, out, rows, hw, s); break;
    case 3: launch<3>(x, seeds, out, rows, hw, s); break;
    case 4: launch<4>(x, seeds, out, rows, hw, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dequant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
