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
// What bounds it: bytes (z and g read once, a dozen fp32 operations per
// element). The design, shared with B1, is the two-pass reduction of
// channel_reduce.cuh: gamma and beta of a thread's channels are loaded once
// into registers, fp32 partials per block go to a scratch buffer that the
// caller allocates, then a fixed-order combine. No atomics: the result is the
// same from run to run on a given card. Division is IEEE (no fast math), as
// in the plain PyTorch version.
//
// Inputs: z, g fp32 or bf16 of one dtype and layout, channels_last NCHW /
// [M, C] (inner = 1) or contiguous NCHW (inner = H*W); gamma, beta fp32 [C].
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include "channel_reduce.cuh"

namespace {

enum Activation { kNone = 0, kLeakyRelu = 1, kElu = 2 };

struct AbnBwdOp {
  const float* gamma;
  const float* beta;
  int act;
  float slope;

  struct Param {
    float gamma, beta;
  };
  __device__ __forceinline__ Param param(int64_t c) const { return {__ldg(gamma + c), __ldg(beta + c)}; }
  __device__ __forceinline__ void apply(const Param& p, float z, float g, float& u,
                                        float& v) const {
    float dy = g, y = z;
    if (z < 0.f) {
      if (act == kLeakyRelu) {
        dy = g * slope;
        y = z / slope;
      } else if (act == kElu) {
        dy = g * (z + 1.f);
        y = log1pf(z);
      }
    }
    const float xhat = (y - p.beta) / p.gamma;
    u = dy;
    v = xhat * dy;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 leaky_relu, 2 elu.
// scratch: 2 * max_parts * channels floats. aligned: z and g are 16-byte
// aligned. out_edz, out_eydz: [channels] float32. Returns a cudaError_t.
extern "C" int abn_bwd_launch(const void* z, const void* g, const void* gamma, const void* beta,
                              void* out_edz, void* out_eydz, void* scratch, long long max_parts,
                              long long numel, long long inner, long long channels, int dtype,
                              int act, float slope, int aligned, void* stream) {
  if (numel <= 0 || inner <= 0 || channels <= 0 || max_parts <= 0 || max_parts > 65535 ||
      numel % (inner * channels) != 0 || (dtype != 0 && dtype != 1) || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AbnBwdOp op{static_cast<const float*>(gamma), static_cast<const float*>(beta), act, slope};
  float* edz = static_cast<float*>(out_edz);
  float* eydz = static_cast<float*>(out_eydz);
  float* work = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return chred::launch_reduce<float, true>(z, g, numel, inner, channels, aligned != 0, op, work,
                                             max_parts, edz, eydz, st);
  }
  return chred::launch_reduce<__nv_bfloat16, true>(z, g, numel, inner, channels, aligned != 0, op,
                                                   work, max_parts, edz, eydz, st);
}
