// The 2x2 mean pool and the 2x nearest-neighbour upsample of NHWC maps,
// float32 or bf16:
//
//   pool2x2_kernel: out[b, i, j, c] = round(sum of x[b, 2i+a, 2j+a', c] / 4),
//                   the four phases (a, a') added in the order (0,0), (1,0),
//                   (0,1), (1,1);
//   up2x2_kernel:   out[b, 2i+a, 2j+a', c] = round(s * x_aa'[b, i, j, c]),
//                   each phase from its own map x_aa' (all four one map on
//                   the path).
//
// The pool is `mean_pool` (rcgan_tpu/ops/conv.py: four strided slices added
// in that order, then divided by 4); the upsample at s = 1 with one map is
// `upsample_depth_to_space` (a channel concat x4 and depth_to_space), and at
// s = 1/4 it is the pool's gradient (ops/kernels/resample_kernel.py). The
// upsample's own gradient is the four strided phases of its cotangent, one
// per map, which autograd adds up as it added the concat's four slices.
//
// They replace no TPU kernel: the JAX package leaves both functions to XLA,
// which fuses the slices and their adds into one pass. Under PyTorch's
// autograd the same functions cost about 21.5 N elements moved per pooled
// map of N inputs (backward: a zero-fill and a strided copy per slice, then
// three full-size adds) and about 4 N per upsample, where the work needs
// 1.25 N: read each input once and write each output once. Both kernels are
// bound by those bytes, so what the design does is move only them:
//
// - one thread owns 16 bytes of channels (8 bf16 or 4 float32) of one row
//   of the smaller map, and loads or stores the four phases of the larger
//   map as 16-byte vectors: neighbouring threads touch neighbouring
//   addresses, and phases (a, 0) and (a, 1) lie side by side. Where C x
//   itemsize is not a multiple of 16 (the 3-channel images) or a pointer is
//   not 16-byte aligned, a thread owns one element instead;
// - the pool keeps its sum in float32 and rounds it to the element type
//   after each add, as the separate tensor adds round (__fadd_rn, so no
//   contraction changes a bit), then rounds sum / 4 once (exact where the
//   result is a normal number); the upsample reads one map once where its
//   four maps are one;
// - the grid strides over rows x vectors with 32-bit indices (the wrapper
//   refuses tensors of 2^31 elements or more) and is capped at 8 blocks of
//   256 threads an SM, the most an SM holds.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() (or cudaErrorInvalidValue for a call they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// elements as stored: float32 as float, bf16 as its 16 bits
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ void narrow(float f, float& out) { out = f; }
__device__ __forceinline__ void narrow(float f, unsigned short& out) {
  out = __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
// f rounded to the element type S, kept in float32
template <typename S>
__device__ __forceinline__ float rounded(float f) {
  S s;
  narrow(f, s);
  return widen(s);
}

template <typename S, int VEC>
struct Vec {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ Vec<S, VEC> load(const S* p) {
  Vec<S, VEC> r;
  if constexpr (sizeof(r) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &q, 16);
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <typename S, int VEC>
__device__ __forceinline__ void store(S* p, const Vec<S, VEC>& r) {
  if constexpr (sizeof(r) == 16) {
    uint4 q;
    memcpy(&q, &r, 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    *p = r.v[0];
  }
}

// items = B*H'*W' output rows x vecs vectors of VEC elements; w2 = W'
template <typename S, int VEC>
__global__ void __launch_bounds__(THREADS)
pool2x2_kernel(const S* __restrict__ x, S* __restrict__ out, uint32_t items, uint32_t vecs,
               uint32_t w2) {
  const int64_t c = static_cast<int64_t>(vecs) * VEC;
  const int64_t row_in = 2 * static_cast<int64_t>(w2) * c;
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < items; i += gridDim.x * THREADS) {
    const uint32_t r = i / vecs, k = i - r * vecs;
    const uint32_t q = r / w2, j = r - q * w2;  // q = b*H' + i: input rows 2q and 2q + 1
    const S* p = x + 2 * static_cast<int64_t>(q) * row_in + 2 * static_cast<int64_t>(j) * c +
                 static_cast<int64_t>(k) * VEC;
    const Vec<S, VEC> v00 = load<S, VEC>(p), v10 = load<S, VEC>(p + row_in),
                      v01 = load<S, VEC>(p + c), v11 = load<S, VEC>(p + row_in + c);
    Vec<S, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float s = rounded<S>(__fadd_rn(widen(v00.v[e]), widen(v10.v[e])));
      s = rounded<S>(__fadd_rn(s, widen(v01.v[e])));
      s = rounded<S>(__fadd_rn(s, widen(v11.v[e])));
      narrow(__fmul_rn(s, 0.25f), o.v[e]);
    }
    store(out + static_cast<int64_t>(r) * c + static_cast<int64_t>(k) * VEC, o);
  }
}

template <typename S, int VEC, bool SCALED>
__device__ __forceinline__ Vec<S, VEC> scaled(Vec<S, VEC> v, float scale) {
  if constexpr (SCALED) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) narrow(__fmul_rn(widen(v.v[e]), scale), v.v[e]);
  }
  return v;
}

// items = B*H*W input rows x vecs vectors; w = W; x00..x11 the phases' maps
// (one = all four the same map, read once); SCALED: s != 1 (else a copy)
template <typename S, int VEC, bool SCALED>
__global__ void __launch_bounds__(THREADS)
up2x2_kernel(const S* __restrict__ x00, const S* __restrict__ x01, const S* __restrict__ x10,
             const S* __restrict__ x11, S* __restrict__ out, uint32_t items, uint32_t vecs,
             uint32_t w, float scale, int one) {
  const int64_t c = static_cast<int64_t>(vecs) * VEC;
  const int64_t row_out = 2 * static_cast<int64_t>(w) * c;
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < items; i += gridDim.x * THREADS) {
    const uint32_t r = i / vecs, k = i - r * vecs;
    const uint32_t q = r / w, j = r - q * w;  // q = b*H + i: output rows 2q and 2q + 1
    const int64_t in = static_cast<int64_t>(r) * c + static_cast<int64_t>(k) * VEC;
    const Vec<S, VEC> v00 = scaled<S, VEC, SCALED>(load<S, VEC>(x00 + in), scale);
    S* p = out + 2 * static_cast<int64_t>(q) * row_out + 2 * static_cast<int64_t>(j) * c +
           static_cast<int64_t>(k) * VEC;
    if (one) {
      store(p, v00);
      store(p + c, v00);
      store(p + row_out, v00);
      store(p + row_out + c, v00);
    } else {
      store(p, v00);
      store(p + c, scaled<S, VEC, SCALED>(load<S, VEC>(x01 + in), scale));
      store(p + row_out, scaled<S, VEC, SCALED>(load<S, VEC>(x10 + in), scale));
      store(p + row_out + c, scaled<S, VEC, SCALED>(load<S, VEC>(x11 + in), scale));
    }
  }
}

int blocks_for(uint32_t items, int sms) {
  const int64_t want = (static_cast<int64_t>(items) + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  return static_cast<int>(want < cap ? want : cap);
}

// 16-byte vectors where every row's channels and every pointer allow them
bool vectors(const void* const* ptrs, int n, int c, int itemsize) {
  bool ok = (static_cast<int64_t>(c) * itemsize) % 16 == 0;
  for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return ok;
}

template <typename S, int VEC>
void launch_pool(const void* x, void* out, int64_t rows, int w2, int c, int sms,
                 cudaStream_t stream) {
  const uint32_t vecs = static_cast<uint32_t>(c / VEC);
  const uint32_t items = static_cast<uint32_t>(rows * vecs);
  pool2x2_kernel<S, VEC><<<blocks_for(items, sms), THREADS, 0, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out), items, vecs, static_cast<uint32_t>(w2));
}

template <typename S, int VEC>
void launch_up(const void* const* xs, void* out, int64_t rows, int w, int c, float scale,
               int sms, cudaStream_t stream) {
  const uint32_t vecs = static_cast<uint32_t>(c / VEC);
  const uint32_t items = static_cast<uint32_t>(rows * vecs);
  const int blocks = blocks_for(items, sms);
  const S *x00 = static_cast<const S*>(xs[0]), *x01 = static_cast<const S*>(xs[1]),
          *x10 = static_cast<const S*>(xs[2]), *x11 = static_cast<const S*>(xs[3]);
  const int one = x01 == x00 && x10 == x00 && x11 == x00;
  if (scale == 1.0f)
    up2x2_kernel<S, VEC, false><<<blocks, THREADS, 0, stream>>>(
        x00, x01, x10, x11, static_cast<S*>(out), items, vecs, static_cast<uint32_t>(w), scale,
        one);
  else
    up2x2_kernel<S, VEC, true><<<blocks, THREADS, 0, stream>>>(
        x00, x01, x10, x11, static_cast<S*>(out), items, vecs, static_cast<uint32_t>(w), scale,
        one);
}

// the arguments every entry point takes: the smaller map's pixels and
// width, the channels, and the larger map under 2^31 elements
bool valid(int64_t rows, int w, int c, int sms) {
  return rows >= 1 && w >= 1 && c >= 1 && sms >= 1 && rows * c * 4 < (int64_t{1} << 31);
}

}  // namespace

extern "C" {

// x [B, 2H', 2W', C] contiguous, out [B, H', W', C] contiguous, both
// float32 (bf16 = 0) or bf16 (bf16 = 1); rows = B*H'*W' output pixels,
// w2 = W'.
int resample_pool2x2(const void* x, void* out, int bf16, long long rows, int w2, int c, int sms,
                     void* stream) {
  if (!valid(rows, w2, c, sms) || rows % w2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[2] = {x, out};
  if (bf16) {
    if (vectors(ptrs, 2, c, 2))
      launch_pool<unsigned short, 8>(x, out, rows, w2, c, sms, s);
    else
      launch_pool<unsigned short, 1>(x, out, rows, w2, c, sms, s);
  } else {
    if (vectors(ptrs, 2, c, 4))
      launch_pool<float, 4>(x, out, rows, w2, c, sms, s);
    else
      launch_pool<float, 1>(x, out, rows, w2, c, sms, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x00, x01, x10, x11 [B, H, W, C] contiguous (the maps of phases (0,0),
// (0,1), (1,0), (1,1); one pointer four times for one map), out [B, 2H, 2W,
// C] contiguous, float32 or bf16; rows = B*H*W input pixels, w = W.
int resample_up2x2(const void* x00, const void* x01, const void* x10, const void* x11, void* out,
                   int bf16, long long rows, int w, int c, float scale, int sms, void* stream) {
  if (!valid(rows, w, c, sms) || rows % w) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[5] = {x00, x01, x10, x11, out};
  if (bf16) {
    if (vectors(ptrs, 5, c, 2))
      launch_up<unsigned short, 8>(ptrs, out, rows, w, c, scale, sms, s);
    else
      launch_up<unsigned short, 1>(ptrs, out, rows, w, c, scale, sms, s);
  } else {
    if (vectors(ptrs, 5, c, 4))
      launch_up<float, 4>(ptrs, out, rows, w, c, scale, sms, s);
    else
      launch_up<float, 1>(ptrs, out, rows, w, c, scale, sms, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
