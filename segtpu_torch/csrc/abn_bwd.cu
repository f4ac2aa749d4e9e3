// From-output InPlaceABN backward sums on Hopper: kernel B3 of segtpu_torch.
//
// Replaces the Pallas kernel segtpu.ops.bn_alt.abn_bwd_pallas
// (segtpu/ops/bn_alt.py:216-283), pass 1 of the memory-saving ABN backward
// (reference lib/modules/abn/functions.py:112, backend.edz_eydz). From the
// layer's output z and its gradient g, per channel c:
//   dy   = g * act'(act^-1(z))         (the activation undone on the gradient)
//   xhat = (act^-1(z) - beta[c]) / gamma[c]
//   edz  = sum dy,   eydz = sum xhat * dy      (fp32)
// leaky_relu(slope): act^-1(z) = z / slope and act' = slope where z < 0;
// elu: act^-1(z) = log1p(z) and act' = z + 1 where z < 0 (log1pf, as segtpu's
// XLA path, segtpu/ops/abn.py:95; the Pallas kernel takes
// log(max(1 + z, 1e-20))); none: the identity. The input x is never read:
// that is the point of the from-output backward.
//
// What bounds it: bytes (z and g read once, about eight fp32 operations per
// element). The design is the one-launch reduction of channel_reduce.cuh,
// shared with B1: one launch per call (the partials combined on chip,
// through distributed shared memory in thread block clusters and then by
// the last cluster leader to arrive); 2 independent 16-byte loads in flight
// per thread and input; no per-element division (below); no host query per
// call (the plan, the SM count and the zeroed counter buffer are cached by
// the Python wrapper, segtpu_torch.ops.kernels). The sums are carried in
// fp64 for fp32 inputs, in fp32 for bf16. No floating-point atomics: the
// same bits from run to run on one card.
//
// No division per element. gamma is constant over a channel, so it comes
// out of the sum: the kernel adds (act^-1(z) - beta) * dy and divides the
// channel's sum by gamma once, where the Pallas kernel multiplies every
// element by a per-channel 1/gamma (bn_alt.py:229,254); 1/slope is computed
// once by the launcher and multiplies. This keeps one per-channel constant
// (beta) in registers, not two, and the vectorised rows kernel within 64
// registers. The plain PyTorch version divides each element (as segtpu's
// XLA path, segtpu/ops/abn.py:389); the two differ by about an ulp per term,
// inside the check's 1e-5 * sum|term|. The activation is a template
// parameter, so each kernel holds only its own activation's code.
//
// Inputs: z, g fp32 or bf16 of one dtype and layout, channels_last NCHW /
// [M, C] (inner = 1) or contiguous NCHW (inner = H*W); gamma, beta fp32 [C].
// Plain C interface, loaded with ctypes: the launcher returns a cudaError_t
// and the Python wrapper raises when it is not 0.

#include "channel_reduce.cuh"

namespace {

enum Activation { kNone = 0, kLeakyRelu = 1, kElu = 2 };

template <int ACT>
struct AbnBwdOp {
  const float* gamma;
  const float* beta;
  float slope;
  float inv_slope;

  struct Param {
    float beta;
  };
  __device__ __forceinline__ Param param(int64_t c) const { return {__ldg(beta + c)}; }
  template <typename A>
  __device__ __forceinline__ void apply(const Param& p, float z, float g, A& u, A& v) const {
    float dy = g, y = z;
    if (ACT == kLeakyRelu && z < 0.f) {
      dy = g * slope;
      y = z * inv_slope;
    } else if (ACT == kElu && z < 0.f) {
      dy = g * (z + 1.f);
      y = log1pf(z);
    }
    u = dy;
    v = (y - p.beta) * dy;  // xhat * dy times gamma: finish() divides once
  }
  template <typename A>
  __device__ __forceinline__ void finish(int64_t c, A&, A& v) const {
    v = v / static_cast<A>(__ldg(gamma + c));
  }
};

template <typename T, int ACT>
int dispatch(const void* z, const void* g, const float* gamma, const float* beta, float slope,
             const chred::Plan& p, const chred::Out& out, cudaStream_t stream) {
  const AbnBwdOp<ACT> op{gamma, beta, slope, 1.f / slope};
  return chred::launch_reduce<T, true>(z, g, op, p, out, stream);
}

template <typename T>
int dispatch_act(const void* z, const void* g, const float* gamma, const float* beta, int act,
                 float slope, const chred::Plan& p, const chred::Out& out, cudaStream_t stream) {
  if (act == kLeakyRelu) return dispatch<T, kLeakyRelu>(z, g, gamma, beta, slope, p, out, stream);
  if (act == kElu) return dispatch<T, kElu>(z, g, gamma, beta, slope, p, out, stream);
  return dispatch<T, kNone>(z, g, gamma, beta, slope, p, out, stream);
}

}  // namespace

// out_edz, out_eydz: [channels] float32. part: [2, clusters, channels]
// sums (fp64 for fp32 inputs, fp32 for bf16) and counters: [tiles] int32 at
// zero, or null when the plan has one cluster per tile. plan: the ReducePlan fields as int64. dtype: 0 =
// float32, 1 = bfloat16. act: 0 none, 1 leaky_relu, 2 elu. Returns a
// cudaError_t.
extern "C" int abn_bwd_launch(const void* z, const void* g, const void* gamma, const void* beta,
                              void* out_edz, void* out_eydz, void* part, void* counters,
                              const long long* plan, int dtype, int act, float slope,
                              void* stream) {
  if (z == nullptr || g == nullptr || gamma == nullptr || beta == nullptr || plan == nullptr ||
      (dtype != 0 && dtype != 1) || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const chred::Plan p = chred::read_plan(plan);
  const chred::Out out{static_cast<float*>(out_edz), static_cast<float*>(out_eydz),
                       part, static_cast<int*>(counters)};
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_act<float>(z, g, gm, bt, act, slope, p, out, st);
  return dispatch_act<__nv_bfloat16>(z, g, gm, bt, act, slope, p, out, st);
}
