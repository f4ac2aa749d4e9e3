// The dx pass of training-mode BatchNorm's backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: segtpu leaves this pass to XLA's fusions
// (segtpu/ops/abn.py _bn_train_bwd), outside any Pallas kernel. It computes,
// per channel c of BNTrain.backward (segtpu_torch/ops/abn.py),
//   dx = g * w[c] - (x - mean[c]) * b2[c] - a[c]
// where w, mean, b2 and a are fp32 [C] vectors made by the caller (already
// expanded to the s2d channels, and already holding the global sums under a
// process group), and g and x share dtype and layout. In plain PyTorch the
// same expression is eight full-size kernels that move 62 bytes per bf16
// element (two upcasts, five fp32 ops, a downcast).
//
// What bounds it: bytes. g and x are read once and dx written once, 6 bytes
// per bf16 element (12 in fp32), at five fp32 operations per element, far
// below the card's ~20 fp32 operations per byte of device memory.
//
// Design: that of B2 (abn_norm_act.cu) with two inputs. The launch plan is
// computed in Python (segtpu_torch.ops.kernels.bn_dx_plan, cached per call
// signature) and checked here (plan_ok); a plan it refuses is
// cudaErrorInvalidValue.
//   rows    inner == 1: channels_last NCHW or a row-major [M, C] view. The
//           tensor is cut into periods of L = lcm(C, VEC) elements, L / VEC
//           vector columns each, so column j of every period holds the same
//           VEC channels. Each thread owns one column for its whole life: it
//           loads its VEC channels' four coefficients into registers once,
//           then walks the periods with a fixed stride, kUnroll 16-byte
//           loads of each input in flight. The loop has no division, no
//           modulo and no per-element coefficient load, whatever C is: C = 4
//           mod 8 in bf16 keeps full 16-byte loads with a period of 2C. A
//           block is tx threads across a tile of columns times ty across
//           consecutive periods, so a warp reads contiguous memory; the grid
//           is kMinBlocks persistent blocks per SM (gridDim.y: the column
//           tiles when a period has more columns than a block has threads).
//           The last, partial period is masked per load, and the n % VEC
//           elements after the last vector go to block 0.
//   planes  inner > 1: contiguous NCHW, off the card's main path. A
//           grid-stride loop over vectors; when inner % VEC == 0 a vector
//           lies in one plane and takes one coefficient set, else the channel
//           is stepped element by element.
// Unaligned views take VEC = 1 on either path. Against B2 the rows path
// keeps 2 loads of each input in flight (4 loads, 64 bytes a thread, as B2's
// 4 of one input) and 3 blocks per SM: the four coefficients of 8 bf16
// channels take 32 registers, so a thread is held to 80 and not 64.
//
// Arithmetic: fp32 in the expression's order, each operation rounded
// (__fmul_rn, __fsub_rn: no contraction into FMAs), then one rounding to the
// output type, so the result has the bits of the plain PyTorch version.
//
// The kernels are templates on BnDxOp, which holds the arithmetic, so that
// their names in a device trace carry "BnDxOp".
//
// Plain C interface, loaded with ctypes: the launcher returns a cudaError_t
// and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // threads per block, at most
constexpr int kMinBlocks = 3;      // rows path: blocks that fit an SM at once (<= 80 registers)
constexpr int kUnroll = 2;         // 16-byte loads of each input in flight per thread, rows path
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;

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
  int64_t unroll;       // loads of each input in flight per thread (1 for planes)
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

// The per-channel vectors and the arithmetic of one element.
struct BnDxOp {
  const float* w;
  const float* mean;
  const float* b2;
  const float* a;

  struct Coef {
    float w, mean, b2, a;
  };
  __device__ __forceinline__ Coef coef(int64_t c) const { return {w[c], mean[c], b2[c], a[c]}; }
  // g * w - (x - mean) * b2 - a, each operation rounded, in that order.
  static __device__ __forceinline__ float apply(const Coef& k, float g, float x) {
    return __fsub_rn(__fsub_rn(__fmul_rn(g, k.w), __fmul_rn(__fsub_rn(x, k.mean), k.b2)), k.a);
  }
};

template <typename Op, typename T>
__device__ __forceinline__ void scalar_element(const Op& op, const T* __restrict__ g,
                                               const T* __restrict__ x, T* __restrict__ dx,
                                               int64_t i, int64_t c) {
  dx[i] = from_float<T>(Op::apply(op.coef(c), to_float(g[i]), to_float(x[i])));
}

template <typename Op, typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
rows_pass(const T* __restrict__ g, const T* __restrict__ x, T* __restrict__ dx, const Op op,
          const Plan p) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  const int64_t n_vec = p.numel / VEC;
  // The n % VEC elements after the last vector.
  const int64_t tail = p.numel - n_vec * VEC;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && t < tail) {
    const int64_t i = n_vec * VEC + t;
    scalar_element(op, g, x, dx, i, i % p.channels);
  }
  const int64_t col = static_cast<int64_t>(blockIdx.y) * p.tx + threadIdx.x;
  if (col >= p.cols) return;
  typename Op::Coef k[VEC];
  int64_t c = (col * VEC) % p.channels;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    k[e] = op.coef(c);
    if (++c == p.channels) c = 0;
  }
  // Vectors between a thread's loads in one trip, and between its trips.
  const int64_t gap = p.ty * p.cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kUnroll * gap;
  const Raw* in_g = reinterpret_cast<const Raw*>(g);
  const Raw* in_x = reinterpret_cast<const Raw*>(x);
  Raw* dst = reinterpret_cast<Raw*>(dx);
  for (int64_t v = (static_cast<int64_t>(blockIdx.x) * kUnroll * p.ty + threadIdx.y) * p.cols + col;
       v < n_vec; v += stride) {
    Raw rg[kUnroll], rx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * gap < n_vec) {
        rg[u] = in_g[v + u * gap];
        rx[u] = in_x[v + u * gap];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * gap < n_vec) {
        float fg[VEC], fx[VEC];
        V::unpack(rg[u], fg);
        V::unpack(rx[u], fx);
#pragma unroll
        for (int e = 0; e < VEC; ++e) fg[e] = Op::apply(k[e], fg[e], fx[e]);
        dst[v + u * gap] = V::pack(fg);
      }
    }
  }
}

template <typename Op, typename T, int VEC, typename I>
__global__ void __launch_bounds__(kMaxThreads)
planes_pass(const T* __restrict__ g, const T* __restrict__ x, T* __restrict__ dx, const Op op,
            I n, I inner, I channels) {
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
    float fg[VEC], fx[VEC];
    V::unpack(reinterpret_cast<const Raw*>(g)[v], fg);
    V::unpack(reinterpret_cast<const Raw*>(x)[v], fx);
    if (one_channel) {
      const typename Op::Coef k = op.coef(c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) fg[e] = Op::apply(k, fg[e], fx[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        fg[e] = Op::apply(op.coef(c), fg[e], fx[e]);
        if (++r == inner) {
          r = 0;
          if (++c == channels) c = 0;
        }
      }
    }
    reinterpret_cast<Raw*>(dx)[v] = V::pack(fg);
  }
  // The last n % VEC elements, one per thread of the first block.
  const I i = n_vec * VEC + first;
  if (i < n) scalar_element(op, g, x, dx, i, (i / inner) % channels);
}

int64_t gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Whether `p` is a plan this file can run for element type T.
template <typename T>
bool plan_ok(const Plan& p, const void* g, const void* x, const void* dx) {
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
  return p.vec == 1 || (aligned16(g) && aligned16(x) && aligned16(dx));
}

template <typename T, int VEC>
cudaError_t launch(const Plan& p, const void* g, const void* x, const BnDxOp& op, void* dx,
                   cudaStream_t stream) {
  const T* pg = static_cast<const T*>(g);
  const T* px = static_cast<const T*>(x);
  T* po = static_cast<T*>(dx);
  if (p.rows_layout == 1) {
    const dim3 grid(static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.col_tiles));
    const dim3 block(static_cast<unsigned>(p.tx), static_cast<unsigned>(p.ty));
    rows_pass<BnDxOp, T, VEC><<<grid, block, 0, stream>>>(pg, px, po, op, p);
  } else if (p.numel + static_cast<int64_t>(kMaxThreads) * VEC < (int64_t{1} << 31)) {
    // 32-bit index arithmetic where it cannot overflow: the per-vector
    // division is several times cheaper than in 64 bits.
    planes_pass<BnDxOp, T, VEC, uint32_t><<<static_cast<unsigned>(p.blocks),
                                            static_cast<unsigned>(p.tx), 0, stream>>>(
        pg, px, po, op, static_cast<uint32_t>(p.numel), static_cast<uint32_t>(p.inner),
        static_cast<uint32_t>(p.channels));
  } else {
    planes_pass<BnDxOp, T, VEC, uint64_t><<<static_cast<unsigned>(p.blocks),
                                            static_cast<unsigned>(p.tx), 0, stream>>>(
        pg, px, po, op, static_cast<uint64_t>(p.numel), static_cast<uint64_t>(p.inner),
        static_cast<uint64_t>(p.channels));
  }
  return cudaGetLastError();
}

}  // namespace

// g, x, dx: one dtype, shape and layout. w, mean, b2, a: float32 [channels].
// plan: NormActPlan.packed of bn_dx_plan. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t: cudaErrorInvalidValue for a plan or argument it
// cannot take, else the launch's own error.
extern "C" int bn_dx_launch(const void* g, const void* x, const void* w, const void* mean,
                            const void* b2, const void* a, void* dx, const long long* plan,
                            int dtype, void* stream) {
  if (plan == nullptr || g == nullptr || x == nullptr || w == nullptr || mean == nullptr ||
      b2 == nullptr || a == nullptr || dx == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  int64_t* dst = reinterpret_cast<int64_t*>(&p);
  for (int i = 0; i < kPlanFields; ++i) dst[i] = plan[i];
  const BnDxOp op{static_cast<const float*>(w), static_cast<const float*>(mean),
                  static_cast<const float*>(b2), static_cast<const float*>(a)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (!plan_ok<float>(p, g, x, dx)) return static_cast<int>(cudaErrorInvalidValue);
    err = p.vec > 1 ? launch<float, 4>(p, g, x, op, dx, st) : launch<float, 1>(p, g, x, op, dx, st);
  } else if (dtype == 1) {
    if (!plan_ok<__nv_bfloat16>(p, g, x, dx)) return static_cast<int>(cudaErrorInvalidValue);
    err = p.vec > 1 ? launch<__nv_bfloat16, 8>(p, g, x, op, dx, st)
                    : launch<__nv_bfloat16, 1>(p, g, x, op, dx, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
