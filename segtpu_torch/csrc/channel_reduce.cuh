// Two-pass per-channel reduction shared by the B1 (channel_sums.cu) and B3
// (abn_bwd.cu) kernels of segtpu_torch.
//
// Every element of a channel contributes a pair (u, v) computed by an
// elementwise functor from one or two inputs of the same layout; the result
// is (sum u, sum v) per channel in fp32.
//
// The TPU kernels this replaces walk a sequential row-tile grid and carry
// the sums across grid steps in VMEM scratch. Blocks of a CUDA grid run in
// parallel and in no order, so the sums are taken in two passes, without
// atomics:
//   pass 1  each block reduces one range of the channel's elements into fp32
//           registers, combines its threads in shared memory in a fixed
//           order, and writes one partial (u, v) per channel into a scratch
//           buffer [parts, C] that the caller allocates;
//   pass 2  one thread per (channel, lane) sums the partials in a fixed
//           strided order, and the lanes are combined in a fixed order.
// The plan (block shape, number of parts) depends only on the shape, the
// dtype, the alignment and the SM count, so the result is the same bit for
// bit from run to run on a given card.
//
// Layouts (channel dim 1, `inner` = the stride between neighbouring channels):
//   inner == 1   channels_last NCHW or a row-major [M, C] view: rows of C.
//                A block covers a tile of channels (16-byte vectors across
//                the channels when C allows) and a range of rows.
//   inner  > 1   contiguous NCHW: N planes of H*W per channel. A block
//                covers one channel and a range of its N*H*W elements,
//                16-byte vectors along the plane when H*W allows.
//
// What bounds it: bytes. Each input element is read once and costs a few
// fp32 operations. 16-byte loads with neighbouring threads on neighbouring
// addresses, and a pass-1 grid of about eight 256-thread blocks per SM, keep
// the loads in flight; the partials are a few MB at most.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chred {

constexpr int kThreads = 256;
constexpr int kCombineLanes = 8;       // pass 2: 32 channels x 8 lanes per block
constexpr int kBlocksPerSM = 8;        // pass-1 grid target

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Op interface:
//   struct Op {
//     struct Param;                                   // per-channel constants
//     __device__ Param param(int64_t c) const;
//     __device__ void apply(const Param& p, float a, float b, float& u, float& v) const;
//   };
// For the single-input form `b` is `a`.

template <typename T, int VEC, bool PAIR, class Op>
__global__ void __launch_bounds__(kThreads)
rows_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t rows,
                    int64_t channels, int tx_n, int64_t rows_per_part, Op op,
                    float* __restrict__ part_u, float* __restrict__ part_v) {
  using P = Pack<T, VEC>;
  __shared__ float sh_u[kThreads * VEC];
  __shared__ float sh_v[kThreads * VEC];
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int ty_n = kThreads / tx_n;
  const int width = tx_n * VEC;  // channels of this block's tile
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * width + tx * VEC;
  const int64_t part = blockIdx.y;
  const int64_t r_begin = part * rows_per_part;
  const int64_t r_end = min64(rows, r_begin + rows_per_part);

  float su[VEC], sv[VEC];
  typename Op::Param prm[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    su[k] = 0.f;
    sv[k] = 0.f;
    prm[k] = op.param(min64(c0 + k, channels - 1));
  }
  // With VEC > 1 the caller guarantees C % VEC == 0, so a vector that starts
  // inside the row lies inside it.
  if (c0 < channels) {
    for (int64_t r = r_begin + ty; r < r_end; r += ty_n) {
      const int64_t off = r * channels + c0;
      const P pa = *reinterpret_cast<const P*>(a + off);
      P pb;
      if constexpr (PAIR) pb = *reinterpret_cast<const P*>(b + off);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float av = to_float(pa.v[k]);
        const float bv = PAIR ? to_float(pb.v[k]) : av;
        float u, v;
        op.apply(prm[k], av, bv, u, v);
        su[k] += u;
        sv[k] += v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh_u[ty * width + tx * VEC + k] = su[k];
    sh_v[ty * width + tx * VEC + k] = sv[k];
  }
  __syncthreads();
  // width <= 32 * VEC <= kThreads: one column of shared memory per thread.
  const int j = threadIdx.x;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * width + j;
  if (j < width && ch < channels) {
    float u = 0.f, v = 0.f;
    for (int y = 0; y < ty_n; ++y) {
      u += sh_u[y * width + j];
      v += sh_v[y * width + j];
    }
    part_u[part * channels + ch] = u;
    part_v[part * channels + ch] = v;
  }
}

template <typename T, int VEC, bool PAIR, class Op>
__global__ void __launch_bounds__(kThreads)
planes_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t channels,
                      int64_t inner, int64_t total_vecs, int64_t vecs_per_part, Op op,
                      float* __restrict__ part_u, float* __restrict__ part_v) {
  using P = Pack<T, VEC>;
  __shared__ float sh_u[kThreads / 32];
  __shared__ float sh_v[kThreads / 32];
  const int64_t ch = blockIdx.x;
  const int64_t part = blockIdx.y;
  const int64_t plane_vecs = inner / VEC;  // inner % VEC == 0 when VEC > 1
  const int64_t v_begin = part * vecs_per_part;
  const int64_t v_end = min64(total_vecs, v_begin + vecs_per_part);
  const typename Op::Param prm = op.param(ch);

  float su = 0.f, sv = 0.f;
  for (int64_t i = v_begin + threadIdx.x; i < v_end; i += kThreads) {
    const int64_t img = i / plane_vecs;
    const int64_t p = i - img * plane_vecs;
    const int64_t off = (img * channels + ch) * inner + p * VEC;
    const P pa = *reinterpret_cast<const P*>(a + off);
    P pb;
    if constexpr (PAIR) pb = *reinterpret_cast<const P*>(b + off);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float av = to_float(pa.v[k]);
      const float bv = PAIR ? to_float(pb.v[k]) : av;
      float u, v;
      op.apply(prm, av, bv, u, v);
      su += u;
      sv += v;
    }
  }
  // Fixed-order block reduction: shuffles within each warp, then warp 0's
  // lane 0 adds the warps' sums in order.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    su += __shfl_down_sync(0xffffffffu, su, d);
    sv += __shfl_down_sync(0xffffffffu, sv, d);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh_u[warp] = su;
    sh_v[warp] = sv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float u = 0.f, v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      u += sh_u[w];
      v += sh_v[w];
    }
    part_u[part * channels + ch] = u;
    part_v[part * channels + ch] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_u, const float* __restrict__ part_v, int64_t parts,
               int64_t channels, float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float sh_u[kCombineLanes][32];
  __shared__ float sh_v[kCombineLanes][32];
  const int col = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * 32 + col;
  float u = 0.f, v = 0.f;
  if (ch < channels) {
    for (int64_t p = lane; p < parts; p += kCombineLanes) {
      u += part_u[p * channels + ch];
      v += part_v[p * channels + ch];
    }
  }
  sh_u[lane][col] = u;
  sh_v[lane][col] = v;
  __syncthreads();
  if (lane == 0 && ch < channels) {
    float tu = 0.f, tv = 0.f;
    for (int l = 0; l < kCombineLanes; ++l) {
      tu += sh_u[l][col];
      tv += sh_v[l][col];
    }
    out_u[ch] = tu;
    out_v[ch] = tv;
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Launch both passes on `stream`. `scratch` holds 2 * max_parts * channels
// floats. `aligned`: every input pointer is 16-byte aligned. Returns
// cudaGetLastError().
template <typename T, bool PAIR, class Op>
int launch_reduce(const void* a, const void* b, int64_t numel, int64_t inner, int64_t channels,
                  bool aligned, const Op& op, float* scratch, int64_t max_parts, float* out_u,
                  float* out_v, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t target = static_cast<int64_t>(sms > 0 ? sms : 1) * kBlocksPerSM;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  float* part_u = scratch;
  float* part_v = scratch + max_parts * channels;
  int64_t parts = 1;

  if (inner == 1) {
    const int64_t rows = numel / channels;
    const bool vec = aligned && channels % kVec == 0;
    const int64_t cv = vec ? channels / kVec : channels;
    int tx_n = 1;
    while (tx_n < 32 && tx_n < cv) tx_n *= 2;
    const int ty_n = kThreads / tx_n;
    const int64_t tiles = cdiv(cv, tx_n);
    parts = clamp64(cdiv(target, tiles), 1, clamp64(cdiv(rows, ty_n), 1, max_parts));
    const int64_t rows_per_part = cdiv(rows, parts);
    parts = cdiv(rows, rows_per_part);
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(parts));
    if (vec) {
      rows_partial_kernel<T, kVec, PAIR, Op><<<grid, kThreads, 0, stream>>>(
          pa, pb, rows, channels, tx_n, rows_per_part, op, part_u, part_v);
    } else {
      rows_partial_kernel<T, 1, PAIR, Op><<<grid, kThreads, 0, stream>>>(
          pa, pb, rows, channels, tx_n, rows_per_part, op, part_u, part_v);
    }
  } else {
    const bool vec = aligned && inner % kVec == 0;
    const int64_t total_vecs = (numel / channels) / (vec ? kVec : 1);
    parts = clamp64(cdiv(target, channels), 1, clamp64(cdiv(total_vecs, kThreads), 1, max_parts));
    const int64_t vecs_per_part = cdiv(total_vecs, parts);
    parts = cdiv(total_vecs, vecs_per_part);
    const dim3 grid(static_cast<unsigned>(channels), static_cast<unsigned>(parts));
    if (vec) {
      planes_partial_kernel<T, kVec, PAIR, Op><<<grid, kThreads, 0, stream>>>(
          pa, pb, channels, inner, total_vecs, vecs_per_part, op, part_u, part_v);
    } else {
      planes_partial_kernel<T, 1, PAIR, Op><<<grid, kThreads, 0, stream>>>(
          pa, pb, channels, inner, total_vecs, vecs_per_part, op, part_u, part_v);
    }
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  combine_kernel<<<static_cast<unsigned>(cdiv(channels, 32)), kThreads, 0, stream>>>(
      part_u, part_v, parts, channels, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chred
