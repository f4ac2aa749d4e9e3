// One-launch per-channel reduction shared by the B1 (channel_sums.cu) and B3
// (abn_bwd.cu) kernels of segtpu_torch, for Hopper (sm_90a).
//
// Replaces the reduction core of the Pallas kernels _pallas_channel_sums
// (segtpu/ops/bn_alt.py:100-159) and abn_bwd_pallas (bn_alt.py:216-283).
// Those walk a sequential row-tile grid and carry their fp32 sums in VMEM
// scratch from one grid step to the next. Blocks of a CUDA grid run in
// parallel and in no order, so here the partial sums are combined on chip.
//
// Every element of a channel contributes a pair (u, v) computed by an
// elementwise functor (Op) from one or two inputs of the same layout; the
// result is (sum u, sum v) per channel in fp32.
//
// What bounds it: bytes. Each input element is read once and costs a few
// operations; the partials are a few KB.
//
// Design: one kernel launch per call, no floating-point atomics, the same
// bits from run to run on one card.
//   plan     computed in Python (segtpu_torch.ops.kernels.reduce_plan) from
//            the shape, dtype, layout, alignment and SM count, and checked
//            here (plan_ok) against the grid, the portable cluster size and
//            the shared arrays; a plan it refuses is an error code.
//   thread   each thread adds its elements into registers in a fixed order,
//            in fp64 for fp32 inputs and in fp32 for bf16 (AccOf below). It
//            issues `unroll` independent 16-byte loads per input (4 for one
//            input, 2 each for two) before it adds any of them.
//   block    warp shuffles (xor, offsets in increasing order), then the
//            warps in order, into shared memory.
//   level 1  the blocks of one channel tile form thread block clusters of
//            up to 8 (the portable size). After cluster.sync(), rank 0 adds
//            the other ranks' partials through distributed shared memory in
//            rank order.
//   level 2  only when a tile has more than one cluster: each cluster leader
//            writes its partial to a scratch buffer, then one thread does
//            __threadfence() and an integer atomicAdd on the tile's counter.
//            The leader that arrives last adds the cluster partials in index
//            order (8 loads in flight per thread and sum), writes the result
//            and sets the counter back to 0. Which leader is last does not
//            change the result: the partials and the order of their sum
//            depend only on the plan. The counters live in an int32 buffer
//            that the caller allocates zeroed once and that every launch
//            leaves at zero, so a call needs no memset. Even the smallest
//            BatchNorm inputs of a LinkNet34 step take several clusters per
//            tile: one cluster of 8 blocks keeps too few bytes in flight, and
//            the second level costs less than that.
//
// Against the two-launch design it replaces (a partials kernel, then a
// separate combine kernel):
//   1. two launches per call -> one; the combine kernel, and the host's
//      second launch, are gone.
//   2. one 16-byte load in flight per thread -> `unroll` per input: 64 B a
//      thread (4 loads of one input, or 2 of each of two), 16 KB a block;
//      the plan gives each SM about 2 blocks (measured against 1 and 4), so
//      about 32 KB in flight per SM against the ~18 KB that 3.35 TB/s x
//      ~0.7 us needs. The bf16 rows kernels are held to 64 registers (4
//      blocks fit an SM), the others to 128 (kMinBlocks). These registers
//      were kept over a cp.async.bulk ring of shared-memory stages fed under
//      mbarriers: they need no shared memory for the stream and no barrier
//      phases, reach most of the bytes bound at the largest shapes, and the
//      calls that fall short are the small ones, whose time is the kernel's
//      fixed cost and not the loads in flight (PERF.md).
//   3. B3's per-element divisions: gamma comes out of the sum and 1/slope is
//      a constant (abn_bwd.cu); its bf16 rows kernel holds 63 registers.
//   4. host work: the launcher queries nothing; the SM count, the plan and
//      the counter buffers are cached by the Python wrapper.
//
// Layouts (channel dim 1, `inner` = the stride between neighbouring channels):
//   rows    inner == 1: channels_last NCHW or a row-major [M, C] view, rows
//           of C. A tile is `width` channels (16-byte vectors across them
//           when C allows); a block covers the tile over `span` rows.
//   planes  inner > 1: contiguous NCHW, N planes of H*W per channel. A tile
//           is one channel; a block covers `span` of its N*H*W/vec vectors.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chred {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// __launch_bounds__: blocks that must fit an SM at once. 4 (<= 64 registers a
// thread) for the rows kernel on bf16 inputs, the main path; 2 (<= 128) for
// fp32 inputs, whose sums are carried in fp64, and for the planes kernel,
// whose per-load index arithmetic spills at 64. The plan's grid gives each
// SM about 2 blocks.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 4 : 2;
constexpr int kPlanesMinBlocks = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 256;  // channels per tile: 32 threads x 8 bf16
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxLanes = 32;   // level 2: threads per channel
constexpr int kBatch = 8;       // level 2: loads in flight per thread and sum
constexpr int64_t kMaxGrid = 2147483647;

// The launch plan, laid out as ReducePlan.packed() in ops/kernels.py.
struct Plan {
  int64_t rows_layout;  // 1: inner == 1, rows of C; 0: NCHW planes
  int64_t vec;          // elements per load: 16 / sizeof(T), or 1
  int64_t tx;           // threads across a tile's channels (1 for planes)
  int64_t width;        // channels per tile: tx * vec (1 for planes)
  int64_t tiles;        // channel tiles
  int64_t extent;       // per tile: rows, or vectors of the channel
  int64_t step;         // rows or vectors a block covers in one loop trip
  int64_t unroll;       // loads in flight per thread and input
  int64_t span;         // rows or vectors per block, a multiple of step
  int64_t cluster;      // blocks per cluster
  int64_t clusters;     // clusters per tile
  int64_t channels;
  int64_t inner;
  int64_t acc_bytes;    // bytes of the type the sums are carried in (Acc<T>)
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int64_t);

// Where the results go. u, v: [channels] fp32. part: [2, clusters,
// channels] of Acc<T> and counters: [tiles] int32 at zero, both needed only
// when clusters > 1.
struct Out {
  float* u;
  float* v;
  void* part;
  int* counters;
};

// The type the sums are carried in, from the thread's running sums to the
// last leader's: fp64 for fp32 inputs, fp32 for bf16. An fp32 input's sums
// feed cancelling differences (the BatchNorm backward takes
// sum g*x - mean * sum g), so they are carried exactly enough to round once
// at the end; a bf16 input's own rounding is 2^16 times coarser than fp32's.
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<float> {
  using type = double;
};
template <typename T>
using Acc = typename AccOf<T>::type;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Element e of a pack as fp32. A bf16 is the top half of an fp32, so a
// 16-byte bf16 pack converts from its 32-bit words with a shift or a mask:
// exact, and it keeps ptxas from holding the pack as eight 16-bit values
// (which made the vectorised rows kernels spill at 64 registers).
template <typename T, int VEC>
__device__ __forceinline__ float elem(const Pack<T, VEC>& pk, int e) {
  if constexpr (sizeof(T) == 2 && VEC > 1) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&pk)[e / 2];
    return __uint_as_float(e % 2 == 0 ? w << 16 : w & 0xffff0000u);
  } else if constexpr (sizeof(T) == 2) {
    return __bfloat162float(pk.v[e]);
  } else {
    return pk.v[e];
  }
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Op interface (A: the accumulation type, float or double):
//   struct Op {
//     struct Param;                                   // per-channel constants
//     __device__ Param param(int64_t c) const;
//     template <typename A>
//     __device__ void apply(const Param& p, float a, float b, A& u, A& v) const;
//     template <typename A>
//     __device__ void finish(int64_t c, A& u, A& v) const;  // on the sums
//   };
// For the single-input form `b` is `a`. finish() runs once per channel on
// the two sums, just before they are written.

// Shared memory of one block: the warps' partials (reused by level 2), the
// block's partial for the tile's channels, and the "last leader" flag.
template <typename A>
struct Smem {
  A warp_u[kWarps * kMaxWidth];
  A warp_v[kWarps * kMaxWidth];
  A blk_u[kMaxWidth];
  A blk_v[kMaxWidth];
  int last;
};

// Levels 1 and 2 for the block that holds its partial in s.blk_u/blk_v for
// the `width` channels of `tile` (channels tile * width + j).
template <typename A, class Op>
__device__ __forceinline__ void finish_tile(Smem<A>& s, int width, int64_t tile, const Plan& p,
                                            const Op& op, const Out& out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's blk_u/blk_v are written
  const unsigned rank = cluster.block_rank();
  const int nranks = static_cast<int>(p.cluster);
  const int j = threadIdx.x;
  A u = 0, v = 0;
  if (rank == 0 && j < width) {
    u = s.blk_u[j];
    v = s.blk_v[j];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < nranks) {
        u += cluster.map_shared_rank(s.blk_u, r)[j];
        v += cluster.map_shared_rank(s.blk_v, r)[j];
      }
    }
  }
  cluster.sync();  // the other ranks stay resident until rank 0 has read them
  if (rank != 0) return;

  const int64_t channels = p.channels;
  const int64_t ch = tile * width + j;
  if (p.clusters == 1) {
    if (j < width && ch < channels) {
      op.finish(ch, u, v);
      out.u[ch] = static_cast<float>(u);
      out.v[ch] = static_cast<float>(v);
    }
    return;
  }
  A* part = static_cast<A*>(out.part);
  const int64_t cl = (blockIdx.x % (p.cluster * p.clusters)) / p.cluster;
  if (j < width && ch < channels) {
    part[cl * channels + ch] = u;
    part[(p.clusters + cl) * channels + ch] = v;
  }
  // As cooperative groups' grid sync: a block barrier, then one thread
  // fences and counts; the last leader's thread fences again before the
  // barrier that lets its block read the other leaders' partials.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s.last = atomicAdd(out.counters + tile, 1) == p.clusters - 1;
    if (s.last) __threadfence();
  }
  __syncthreads();
  if (!s.last) return;
  // The last leader: min(kThreads / width, kMaxLanes) lanes per channel
  // (width is a power of two); lane l adds clusters l, l + lanes, ... in
  // order, then the lanes are added in order.
  const int lanes = kThreads / width < kMaxLanes ? kThreads / width : kMaxLanes;
  const int jj = threadIdx.x % width;
  const int lane = threadIdx.x / width;
  const int64_t cc = tile * width + jj;
  A lu = 0, lv = 0;
  if (lane < lanes && cc < channels) {
    // kBatch partials of each sum in flight before they are added
    for (int64_t k0 = lane; k0 < p.clusters; k0 += kBatch * lanes) {
      A bu[kBatch], bv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int64_t k = k0 + static_cast<int64_t>(i) * lanes;
        if (k < p.clusters) {
          bu[i] = __ldcg(part + k * channels + cc);
          bv[i] = __ldcg(part + (p.clusters + k) * channels + cc);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (k0 + static_cast<int64_t>(i) * lanes < p.clusters) {
          lu += bu[i];
          lv += bv[i];
        }
      }
    }
  }
  if (lane < lanes) {
    s.warp_u[lane * width + jj] = lu;
    s.warp_v[lane * width + jj] = lv;
  }
  __syncthreads();
  if (j < width && ch < channels) {
    A tu = 0, tv = 0;
    for (int l = 0; l < lanes; ++l) {
      tu += s.warp_u[l * width + j];
      tv += s.warp_v[l * width + j];
    }
    op.finish(ch, tu, tv);
    out.u[ch] = static_cast<float>(tu);
    out.v[ch] = static_cast<float>(tv);
  }
  if (threadIdx.x == 0) out.counters[tile] = 0;
}

template <typename T, int VEC, bool PAIR, int MAXU, class Op>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
rows_kernel(const T* __restrict__ a, const T* __restrict__ b, const Plan p, const Op op,
            const Out out) {
  using P = Pack<T, VEC>;
  using A = Acc<T>;
  __shared__ Smem<A> s;
  const int tx_n = static_cast<int>(p.tx);
  const int ty_n = kThreads / tx_n;
  const int width = static_cast<int>(p.width);
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int unroll = static_cast<int>(p.unroll);
  const int64_t channels = p.channels;
  const int64_t per_tile = p.cluster * p.clusters;
  const int64_t tile = blockIdx.x / per_tile;
  const int64_t blk = blockIdx.x - tile * per_tile;
  const int64_t c0 = tile * width + tx * VEC;
  const int64_t r_begin = blk * p.span;
  const int64_t r_end = min64(p.extent, r_begin + p.span);

  A su[VEC], sv[VEC];
  typename Op::Param prm[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    su[k] = 0;
    sv[k] = 0;
    prm[k] = op.param(min64(c0 + k, channels - 1));
  }
  // With VEC > 1 the plan has C % VEC == 0, so a vector that starts inside
  // the row lies inside it. Thread ty adds rows r_begin + ty + i * ty_n for
  // i = 0, 1, ... in order, `unroll` of them per trip, all loaded before
  // any is added. One 64-bit offset walks the rows.
  const int64_t row0 = r_begin + ty;
  int64_t left = row0 < r_end ? (r_end - row0 + ty_n - 1) / ty_n : 0;  // this thread's rows
  if (c0 >= channels) left = 0;
  const int64_t between = static_cast<int64_t>(ty_n) * channels;
  int64_t off = row0 * channels + c0;
  for (; left > 0; left -= unroll, off += unroll * between) {
    const int n = left < unroll ? static_cast<int>(left) : unroll;
    P pa[MAXU], pb[MAXU];
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      if (k < n) {
        pa[k] = *reinterpret_cast<const P*>(a + off + k * between);
        if constexpr (PAIR) pb[k] = *reinterpret_cast<const P*>(b + off + k * between);
      }
    }
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      if (k < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float av = elem(pa[k], e);
          const float bv = PAIR ? elem(pb[k], e) : av;
          A u, v;
          op.apply(prm[e], av, bv, u, v);
          su[e] += u;
          sv[e] += v;
        }
      }
    }
  }
  // Lanes tx, tx + tx_n, ... of a warp hold the same channels.
  for (int d = tx_n; d < 32; d <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      su[e] += __shfl_xor_sync(0xffffffffu, su[e], d);
      sv[e] += __shfl_xor_sync(0xffffffffu, sv[e], d);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < tx_n) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s.warp_u[warp * width + tx * VEC + e] = su[e];
      s.warp_v[warp * width + tx * VEC + e] = sv[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < width) {
    A u = 0, v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      u += s.warp_u[w * width + threadIdx.x];
      v += s.warp_v[w * width + threadIdx.x];
    }
    s.blk_u[threadIdx.x] = u;
    s.blk_v[threadIdx.x] = v;
  }
  finish_tile(s, width, tile, p, op, out);
}

template <typename T, int VEC, bool PAIR, int MAXU, class Op>
__global__ void __launch_bounds__(kThreads, kPlanesMinBlocks)
planes_kernel(const T* __restrict__ a, const T* __restrict__ b, const Plan p, const Op op,
              const Out out) {
  using P = Pack<T, VEC>;
  using A = Acc<T>;
  __shared__ Smem<A> s;
  const int unroll = static_cast<int>(p.unroll);
  const int64_t channels = p.channels;
  const int64_t per_tile = p.cluster * p.clusters;
  const int64_t ch = blockIdx.x / per_tile;
  const int64_t blk = blockIdx.x - ch * per_tile;
  // the plan has inner % VEC == 0 and extent < 2^31, so 32-bit indices
  const uint32_t plane_vecs = static_cast<uint32_t>(p.inner / VEC);
  const int64_t v_begin = blk * p.span;
  const int64_t v_end = min64(p.extent, v_begin + p.span);
  const typename Op::Param prm = op.param(ch);

  // Thread t adds vectors v_begin + t + i * kThreads for i = 0, 1, ... in
  // order, `unroll` of them per trip, and the elements of each vector in
  // order.
  A su = 0, sv = 0;
  const int64_t first = v_begin + threadIdx.x;
  int64_t left = first < v_end ? (v_end - first + kThreads - 1) / kThreads : 0;
  for (int64_t i = first; left > 0; left -= unroll, i += static_cast<int64_t>(unroll) * kThreads) {
    const int n = left < unroll ? static_cast<int>(left) : unroll;
    P pa[MAXU], pb[MAXU];
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      if (k < n) {
        const uint32_t ii = static_cast<uint32_t>(i + k * kThreads);
        const uint32_t img = ii / plane_vecs;
        const int64_t off = (static_cast<int64_t>(img) * channels + ch) * p.inner +
                            static_cast<int64_t>(ii - img * plane_vecs) * VEC;
        pa[k] = *reinterpret_cast<const P*>(a + off);
        if constexpr (PAIR) pb[k] = *reinterpret_cast<const P*>(b + off);
      }
    }
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      if (k < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float av = elem(pa[k], e);
          const float bv = PAIR ? elem(pb[k], e) : av;
          A u, v;
          op.apply(prm, av, bv, u, v);
          su += u;
          sv += v;
        }
      }
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    su += __shfl_xor_sync(0xffffffffu, su, d);
    sv += __shfl_xor_sync(0xffffffffu, sv, d);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s.warp_u[warp] = su;
    s.warp_v[warp] = sv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    A u = 0, v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      u += s.warp_u[w];
      v += s.warp_v[w];
    }
    s.blk_u[0] = u;
    s.blk_v[0] = v;
  }
  finish_tile(s, 1, ch, p, op, out);
}

inline bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

// Whether `p` is a plan this header can run for element type T: the tiles
// cover the channels, the blocks cover the extent, the shared arrays hold
// the tile, the cluster is at most the portable 8 blocks and divides the
// tile's blocks, the grid fits, and vectors are aligned.
template <typename T, int MAXU>
bool plan_ok(const Plan& p, const void* a, const void* b, const Out& out) {
  constexpr int64_t kVec = 16 / sizeof(T);
  const bool base = p.channels > 0 && p.inner > 0 && (p.vec == 1 || p.vec == kVec) &&
                    p.unroll >= 1 && p.unroll <= MAXU && p.cluster >= 1 &&
                    p.cluster <= kMaxCluster && p.clusters >= 1 && p.tiles >= 1 &&
                    p.extent >= 1 && p.step >= 1 && p.span >= p.step && p.span % p.step == 0 &&
                    p.clusters <= kMaxGrid / p.cluster &&
                    p.span * p.cluster * p.clusters >= p.extent &&
                    p.tiles <= kMaxGrid / (p.cluster * p.clusters);
  if (!base) return false;
  bool layout;
  if (p.rows_layout == 1) {
    layout = p.inner == 1 && pow2(p.tx) && p.tx <= 32 && p.width == p.tx * p.vec &&
             p.width <= kMaxWidth && p.step == (kThreads / p.tx) * p.unroll &&
             p.tiles == (p.channels / p.vec + p.tx - 1) / p.tx && p.channels % p.vec == 0;
  } else {
    layout = p.rows_layout == 0 && p.tx == 1 && p.width == 1 && p.tiles == p.channels &&
             p.step == kThreads * p.unroll && p.inner % p.vec == 0 &&
             p.extent + p.step < (int64_t{1} << 31);
  }
  if (!layout || p.acc_bytes != static_cast<int64_t>(sizeof(Acc<T>))) return false;
  if (p.vec > 1 && (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
                    (b != nullptr && reinterpret_cast<uintptr_t>(b) % 16 != 0))) {
    return false;
  }
  if (out.u == nullptr || out.v == nullptr) return false;
  if (p.clusters > 1 && (out.part == nullptr || out.counters == nullptr)) return false;
  return true;
}

// Launches the one kernel of a call on `stream`, with clusters of
// p.cluster blocks. Returns a cudaError_t: cudaErrorInvalidValue for a plan
// that plan_ok refuses, else the launch's own error.
template <typename T, bool PAIR, class Op>
int launch_reduce(const void* a, const void* b, const Op& op, const Plan& p, const Out& out,
                  cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kMaxU = PAIR ? 2 : 4;
  if (!plan_ok<T, kMaxU>(p, a, PAIR ? b : nullptr, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.tiles * p.cluster * p.clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  cudaError_t err;
  if (p.rows_layout == 1) {
    err = p.vec > 1 ? cudaLaunchKernelEx(&cfg, rows_kernel<T, kVec, PAIR, kMaxU, Op>, pa, pb, p,
                                         op, out)
                    : cudaLaunchKernelEx(&cfg, rows_kernel<T, 1, PAIR, kMaxU, Op>, pa, pb, p,
                                         op, out);
  } else {
    err = p.vec > 1 ? cudaLaunchKernelEx(&cfg, planes_kernel<T, kVec, PAIR, kMaxU, Op>, pa, pb,
                                         p, op, out)
                    : cudaLaunchKernelEx(&cfg, planes_kernel<T, 1, PAIR, kMaxU, Op>, pa, pb, p,
                                         op, out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan from the host array that the Python wrapper passes.
inline Plan read_plan(const long long* fields) {
  Plan p;
  int64_t* dst = reinterpret_cast<int64_t*>(&p);
  for (int i = 0; i < kPlanFields; ++i) dst[i] = fields[i];
  return p;
}

}  // namespace chred
