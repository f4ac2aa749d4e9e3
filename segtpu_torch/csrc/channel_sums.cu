// Per-channel fp32 sums (sum a, sum a*b) on Hopper: kernel B1 of segtpu_torch.
//
// Replaces the Pallas kernel segtpu.ops.bn_alt._pallas_channel_sums
// (segtpu/ops/bn_alt.py:100-159), which reads an [M, C] operand once and
// accumulates both fp32 channel sums in VMEM scratch across a sequential
// row-tile grid. With b absent, b = a and the pair is (sum x, sum x^2), the
// BatchNorm statistics; with b present it is the BatchNorm backward's
// (sum g, sum g*x).
//
// What bounds it: bytes (each input element read once, two or three
// operations each). The design is the one-launch reduction of
// channel_reduce.cuh, shared with B3, which answers the four limits of the
// two-launch design it replaces: one launch per call (the partials are
// combined on chip, through distributed shared memory in thread block
// clusters and then by the last cluster leader to arrive); 4 independent
// 16-byte loads in flight per thread for one input, 2 per input for two;
// no per-element division (B1 has none); and no host query per call (the
// plan, the SM count and the zeroed counter buffer are cached by the Python
// wrapper, segtpu_torch.ops.kernels). No floating-point atomics: the same
// bits from run to run on one card.
//
// fp32 inputs are summed in fp64 (products exact), bf16 inputs in fp32: the
// BatchNorm backward takes sum g*x - mean * sum g, a difference that
// cancels, so the sums of an fp32 input are carried exactly enough to round
// once.
//
// Inputs: fp32 or bf16, channels_last NCHW / [M, C] (inner = 1) or
// contiguous NCHW (inner = H*W); a and b share dtype and layout.
// Plain C interface, loaded with ctypes: the launcher returns a cudaError_t
// and the Python wrapper raises when it is not 0.

#include "channel_reduce.cuh"

namespace {

struct SumsOp {
  struct Param {};
  __device__ __forceinline__ Param param(int64_t) const { return {}; }
  template <typename A>
  __device__ __forceinline__ void apply(const Param&, float a, float b, A& u, A& v) const {
    u = a;
    v = static_cast<A>(a) * static_cast<A>(b);  // exact in fp64
  }
  template <typename A>
  __device__ __forceinline__ void finish(int64_t, A&, A&) const {}
};

template <typename T>
int dispatch(const void* a, const void* b, const chred::Plan& p, const chred::Out& out,
             cudaStream_t stream) {
  if (b != nullptr) return chred::launch_reduce<T, true>(a, b, SumsOp{}, p, out, stream);
  return chred::launch_reduce<T, false>(a, nullptr, SumsOp{}, p, out, stream);
}

}  // namespace

// b may be null (single form). out_s, out_q: [channels] float32. part:
// [2, clusters, channels] sums (fp64 for fp32 inputs, fp32 for bf16) and
// counters: [tiles] int32 at zero, or null when the plan has one cluster
// per tile. plan: the ReducePlan fields
// as int64. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int channel_sums_launch(const void* a, const void* b, void* out_s, void* out_q,
                                   void* part, void* counters, const long long* plan, int dtype,
                                   void* stream) {
  if (a == nullptr || plan == nullptr || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const chred::Plan p = chred::read_plan(plan);
  const chred::Out out{static_cast<float*>(out_s), static_cast<float*>(out_q),
                       part, static_cast<int*>(counters)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, p, out, st);
  return dispatch<__nv_bfloat16>(a, b, p, out, st);
}
