// Fused per-channel affine + activation (B2) for Hopper (sm_90a).
//
// Replaces the Pallas kernel abn_norm_act_pallas (segtpu/ops/bn_alt.py:181):
// out = act(x * scale + shift) per channel, where scale = gamma * rsqrt(var +
// eps) and shift = beta - mean * scale are fp32 [C] vectors made by the
// caller, and act is leaky_relu(slope), elu or none. The Pallas kernel keeps
// the (1, C) scale and shift blocks in VMEM beside each (tile_m, C) tile.
//
// What bounds it: bytes. Each element is read once and written once and
// costs a handful of fp32 operations, far below the card's ~20 fp32
// operations per byte of device memory.
//
// Design. The launch plan is computed in Python (segtpu_torch.ops.kernels.
// norm_act_plan, cached per call signature) and checked here (plan_ok); a
// plan it refuses is cudaErrorInvalidValue.
//   rows    inner == 1: channels_last NCHW or a row-major [M, C] view. The
//           tensor is cut into periods of L = lcm(C, VEC) elements, L / VEC
//           vector columns each, so column j of every period holds the same
//           VEC channels, (j * VEC + e) mod C. Each thread owns one column
//           for its whole life: it loads its VEC scale and VEC shift values
//           into registers once, then walks the periods with a fixed stride,
//           UNROLL independent 16-byte loads in flight. The loop has no
//           division, no modulo and no per-element load or compare, whatever
//           C is: C = 4 mod 8 in bf16 keeps full 16-byte loads with a period
//           of 2C. A block is tx threads across a tile of columns times ty
//           across consecutive periods, so a warp reads contiguous memory;
//           the grid is a few persistent blocks per SM (gridDim.y: the
//           column tiles when a period has more columns than a block has
//           threads). The last, partial period is masked per load, and the
//           n % VEC elements after the last vector go to block 0.
//   planes  inner > 1: contiguous NCHW, off the card's main path (models run
//           channels_last there). A grid-stride loop over vectors; when
//           inner % VEC == 0 a vector lies in one channel and takes one scale
//           and shift, else the channel is stepped element by element.
// Unaligned views take VEC = 1 on either path.
//
// What this replaces, and why: the kernel before did, per 16-byte vector, a
// runtime division and modulo for the channel, then two scalar loads of
// scale and shift and a wrap-around compare per element. In channels_last a
// warp's scalar loads of scale spread over up to eight 128-byte lines at
// C >= 256, so those loads, and not the bytes, set its time at wide C (52%
// of the bound at C = 272, 76-78% at C = 32 and 64; PERF.md).
//
// Arithmetic: fp32 with one rounding to the output type. The multiply and
// add are kept apart (__fmul_rn, __fadd_rn) so the result matches the plain
// PyTorch version, which does not fuse them; ELU uses expm1f.
//
// Plain C interface, loaded with ctypes: the launcher returns a cudaError_t
// and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // threads per block, at most
constexpr int kMinBlocks = 4;      // blocks that fit an SM at once (<= 64 registers)
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread, rows path
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;

enum Activation { kNone = 0, kLeakyRelu = 1, kElu = 2 };

// The launch plan, laid out as NormActPlan.packed in ops/kernels.py.
struct Plan {
  int64_t rows_layout;  // 1: inner == 1, periods of columns; 0: NCHW planes
  int64_t vec;          // elements per load: 16 bytes' worth, or 1
  int64_t channels;
  int64_t inner;        // stride between neighbouring channels
  int64_t numel;
  int64_t cols;         // vector columns of a period, lcm(C, vec) / vec (0 for planes)
  int64_t tx;           // threads across a tile of columns (planes: per block)
  int64_t ty;           // threads across periods (1 for planes)
  int64_t col_tiles;    // gridDim.y (1 for planes)
  int64_t unroll;       // loads in flight per thread (1 for planes)
  int64_t blocks;       // gridDim.x
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int64_t);

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

// One load of VEC elements (16 bytes, or one element) and its conversions.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// bf16 from 32-bit words: the low half is the element at the lower address.
__device__ __forceinline__ void unpack_word(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_word(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    unpack_word(r.x, f[0], f[1]);
    unpack_word(r.y, f[2], f[3]);
    unpack_word(r.z, f[4], f[5]);
    unpack_word(r.w, f[6], f[7]);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[8]) {
    return make_uint4(pack_word(f[0], f[1]), pack_word(f[2], f[3]), pack_word(f[4], f[5]),
                      pack_word(f[6], f[7]));
  }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = to_float(r); }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) { return from_float<T>(f[0]); }
};

__device__ __forceinline__ float norm_act(float x, float s, float b, int act, float slope) {
  const float y = __fadd_rn(__fmul_rn(x, s), b);
  if (act == kLeakyRelu) return y >= 0.f ? y : __fmul_rn(y, slope);
  if (act == kElu) return y >= 0.f ? y : expm1f(y);
  return y;
}

template <typename T>
__device__ __forceinline__ void scalar_element(const T* __restrict__ x, const float* __restrict__ scale,
                                               const float* __restrict__ shift, T* __restrict__ out,
                                               int64_t i, int64_t c, int act, float slope) {
  out[i] = from_float<T>(norm_act(to_float(x[i]), scale[c], shift[c], act, slope));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
abn_norm_act_rows(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out, const Plan p, int act,
                  float slope) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  const int64_t n_vec = p.numel / VEC;
  // The n % VEC elements after the last vector.
  const int64_t tail = p.numel - n_vec * VEC;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && t < tail) {
    const int64_t i = n_vec * VEC + t;
    scalar_element(x, scale, shift, out, i, i % p.channels, act, slope);
  }
  const int64_t col = static_cast<int64_t>(blockIdx.y) * p.tx + threadIdx.x;
  if (col >= p.cols) return;
  float s[VEC], b[VEC];
  int64_t c = (col * VEC) % p.channels;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s[e] = scale[c];
    b[e] = shift[c];
    if (++c == p.channels) c = 0;
  }
  // Vectors between a thread's loads in one trip, and between its trips.
  const int64_t gap = p.ty * p.cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kUnroll * gap;
  const Raw* in = reinterpret_cast<const Raw*>(x);
  Raw* dst = reinterpret_cast<Raw*>(out);
  for (int64_t v = (static_cast<int64_t>(blockIdx.x) * kUnroll * p.ty + threadIdx.y) * p.cols + col;
       v < n_vec; v += stride) {
    Raw r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * gap < n_vec) r[u] = in[v + u * gap];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * gap < n_vec) {
        float f[VEC];
        V::unpack(r[u], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = norm_act(f[e], s[e], b[e], act, slope);
        dst[v + u * gap] = V::pack(f);
      }
    }
  }
}

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kMaxThreads)
abn_norm_act_planes(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out, I n, I inner,
                    I channels, int act, float slope) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  const I n_vec = n / VEC;
  const I first = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const bool one_channel = inner % VEC == 0;  // each vector lies in one plane
  for (I v = first; v < n_vec; v += stride) {
    const I q = v * VEC / inner;
    I r = v * VEC - q * inner;
    I c = q % channels;
    float f[VEC];
    V::unpack(reinterpret_cast<const Raw*>(x)[v], f);
    if (one_channel) {
      const float s = scale[c], b = shift[c];
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = norm_act(f[e], s, b, act, slope);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        f[e] = norm_act(f[e], scale[c], shift[c], act, slope);
        if (++r == inner) {
          r = 0;
          if (++c == channels) c = 0;
        }
      }
    }
    reinterpret_cast<Raw*>(out)[v] = V::pack(f);
  }
  // The last n % VEC elements, one per thread of the first block.
  const I i = n_vec * VEC + first;
  if (i < n) scalar_element(x, scale, shift, out, i, (i / inner) % channels, act, slope);
}

int64_t gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Whether `p` is a plan this file can run for element type T.
template <typename T>
bool plan_ok(const Plan& p, const void* x, const void* out) {
  constexpr int64_t kVec = 16 / sizeof(T);
  const bool base = p.numel > 0 && p.channels > 0 && p.inner > 0 &&
                    p.numel % p.channels == 0 && (p.numel / p.channels) % p.inner == 0 &&
                    (p.vec == 1 || p.vec == kVec) && p.tx >= 1 && p.ty >= 1 &&
                    p.tx * p.ty <= kMaxThreads && p.blocks >= 1 && p.blocks <= kMaxGridX;
  if (!base) return false;
  bool layout;
  if (p.rows_layout == 1) {
    const int64_t period = p.channels / gcd(p.channels, p.vec) * p.vec;
    layout = p.inner == 1 && p.cols == period / p.vec && p.unroll == kUnroll &&
             p.col_tiles == (p.cols + p.tx - 1) / p.tx && p.col_tiles <= kMaxGridY;
  } else {
    layout = p.rows_layout == 0 && p.cols == 0 && p.ty == 1 && p.col_tiles == 1 &&
             p.unroll == 1;
  }
  if (!layout) return false;
  if (p.vec > 1 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return false;
  }
  return true;
}

template <typename T, int VEC>
cudaError_t launch(const Plan& p, const void* x, const float* scale, const float* shift,
                   void* out, int act, float slope, cudaStream_t stream) {
  const T* px = static_cast<const T*>(x);
  T* po = static_cast<T*>(out);
  if (p.rows_layout == 1) {
    const dim3 grid(static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.col_tiles));
    const dim3 block(static_cast<unsigned>(p.tx), static_cast<unsigned>(p.ty));
    abn_norm_act_rows<T, VEC><<<grid, block, 0, stream>>>(px, scale, shift, po, p, act, slope);
  } else if (p.numel + static_cast<int64_t>(kMaxThreads) * VEC < (int64_t{1} << 31)) {
    // 32-bit index arithmetic where it cannot overflow: the per-vector
    // division is several times cheaper than in 64 bits.
    abn_norm_act_planes<T, VEC, uint32_t><<<static_cast<unsigned>(p.blocks),
                                            static_cast<unsigned>(p.tx), 0, stream>>>(
        px, scale, shift, po, static_cast<uint32_t>(p.numel), static_cast<uint32_t>(p.inner),
        static_cast<uint32_t>(p.channels), act, slope);
  } else {
    abn_norm_act_planes<T, VEC, uint64_t><<<static_cast<unsigned>(p.blocks),
                                            static_cast<unsigned>(p.tx), 0, stream>>>(
        px, scale, shift, po, static_cast<uint64_t>(p.numel), static_cast<uint64_t>(p.inner),
        static_cast<uint64_t>(p.channels), act, slope);
  }
  return cudaGetLastError();
}

}  // namespace

// plan: NormActPlan.packed. dtype: 0 = float32, 1 = bfloat16. act: 0 none,
// 1 leaky_relu, 2 elu. Returns a cudaError_t: cudaErrorInvalidValue for a
// plan or argument it cannot take, else the launch's own error.
extern "C" int abn_norm_act_launch(const void* x, const void* scale, const void* shift, void* out,
                                   const long long* plan, int dtype, int act, float slope,
                                   void* stream) {
  if (plan == nullptr || x == nullptr || scale == nullptr || shift == nullptr ||
      out == nullptr || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  int64_t* dst = reinterpret_cast<int64_t*>(&p);
  for (int i = 0; i < kPlanFields; ++i) dst[i] = plan[i];
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (!plan_ok<float>(p, x, out)) return static_cast<int>(cudaErrorInvalidValue);
    err = p.vec > 1 ? launch<float, 4>(p, x, s, b, out, act, slope, st)
                    : launch<float, 1>(p, x, s, b, out, act, slope, st);
  } else if (dtype == 1) {
    if (!plan_ok<__nv_bfloat16>(p, x, out)) return static_cast<int>(cudaErrorInvalidValue);
    err = p.vec > 1 ? launch<__nv_bfloat16, 8>(p, x, s, b, out, act, slope, st)
                    : launch<__nv_bfloat16, 1>(p, x, s, b, out, act, slope, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
