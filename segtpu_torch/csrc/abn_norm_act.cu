// Fused per-channel affine + activation for eval-mode InPlaceABN on Hopper.
//
// Replaces the Pallas kernel segtpu.ops.bn_alt.abn_norm_act_pallas
// (segtpu/ops/bn_alt.py:181-213): out = act(x * scale + shift), where
// scale = gamma * rsqrt(var + eps) and shift = beta - mean * scale are
// precomputed per channel in fp32 by the caller, and act is leaky_relu(slope),
// elu or none.
//
// What bounds it: bytes. Each element is read once and written once and costs
// a handful of fp32 operations, far below the card's ~295 operations per byte
// of device memory. So the design only has to move the bytes at full rate:
//   * every thread loads and stores 16 bytes at a time (4 fp32 or 8 bf16
//     values) when both pointers are 16-byte aligned, neighbouring threads on
//     neighbouring addresses; a scalar instantiation covers unaligned views;
//   * a grid-stride loop over a grid sized to the SM count, so each block
//     works many vectors and the read-only scale/shift stay in L1;
//   * the channel of element i is (i / inner) % C, one division per vector,
//     then stepped element by element. inner = 1 is channels_last (or a
//     row-major [M, C] view) and inner = H*W is contiguous NCHW, so both
//     layouts run with no copy;
//   * fp32 arithmetic with one rounding to the output type. The multiply and
//     add are kept apart (__fmul_rn, __fadd_rn) so the result matches the
//     plain PyTorch version, which does not fuse them; ELU uses expm1f.
//
// Plain C interface, loaded with ctypes: the launcher returns cudaGetLastError()
// and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 16;

enum Activation { kNone = 0, kLeakyRelu = 1, kElu = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float norm_act(float x, float s, float b, int act, float slope) {
  const float y = __fadd_rn(__fmul_rn(x, s), b);
  if (act == kLeakyRelu) return y >= 0.f ? y : __fmul_rn(y, slope);
  if (act == kElu) return y >= 0.f ? y : expm1f(y);
  return y;
}

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
abn_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out, I n,
                    I inner, I channels, int act, float slope) {
  using P = Pack<T, VEC>;
  const I n_vec = n / VEC;
  const I first = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I v = first; v < n_vec; v += stride) {
    const I i0 = v * VEC;
    const I q = i0 / inner;
    I r = i0 - q * inner;
    I c = q % channels;
    P p = reinterpret_cast<const P*>(x)[v];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      p.v[k] = from_float<T>(norm_act(to_float(p.v[k]), __ldg(scale + c), __ldg(shift + c),
                                      act, slope));
      if (++r == inner) {
        r = 0;
        if (++c == channels) c = 0;
      }
    }
    reinterpret_cast<P*>(out)[v] = p;
  }
  // The last n % VEC elements, one per thread of the first block.
  const I i = n_vec * VEC + first;
  if (i < n) {
    const I c = (i / inner) % channels;
    out[i] = from_float<T>(norm_act(to_float(x[i]), __ldg(scale + c), __ldg(shift + c), act, slope));
  }
}

template <typename T, int VEC, typename I>
void launch(const void* x, const float* scale, const float* shift, void* out, int64_t n,
            int64_t inner, int64_t channels, int act, float slope, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t n_vec = n / VEC;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  abn_norm_act_kernel<T, VEC, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), static_cast<I>(n),
      static_cast<I>(inner), static_cast<I>(channels), act, slope);
}

template <typename T, int VEC>
void launch_index(const void* x, const float* scale, const float* shift, void* out, int64_t n,
                  int64_t inner, int64_t channels, int act, float slope, cudaStream_t stream) {
  // 32-bit index arithmetic where it cannot overflow: the per-vector division
  // is several times cheaper than in 64 bits.
  if (n + static_cast<int64_t>(kThreads) * VEC < (int64_t(1) << 31)) {
    launch<T, VEC, uint32_t>(x, scale, shift, out, n, inner, channels, act, slope, stream);
  } else {
    launch<T, VEC, uint64_t>(x, scale, shift, out, n, inner, channels, act, slope, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 leaky_relu, 2 elu.
// vectorized: 1 when x and out are 16-byte aligned. Returns a cudaError_t.
extern "C" int abn_norm_act_launch(const void* x, const void* scale, const void* shift, void* out,
                                   long long n, long long inner, long long channels, int dtype,
                                   int act, float slope, int vectorized, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || inner <= 0 || channels <= 0 || (dtype != 0 && dtype != 1) || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    if (vectorized) launch_index<float, 4>(x, s, b, out, n, inner, channels, act, slope, st);
    else launch_index<float, 1>(x, s, b, out, n, inner, channels, act, slope, st);
  } else {
    if (vectorized) launch_index<__nv_bfloat16, 8>(x, s, b, out, n, inner, channels, act, slope, st);
    else launch_index<__nv_bfloat16, 1>(x, s, b, out, n, inner, channels, act, slope, st);
  }
  return static_cast<int>(cudaGetLastError());
}
