// Per-channel fp32 sums (sum a, sum a*b) on Hopper: kernel B1 of segtpu_torch.
//
// Replaces the Pallas kernel segtpu.ops.bn_alt._pallas_channel_sums
// (segtpu/ops/bn_alt.py:100-159), which reads an [M, C] operand once and
// accumulates both fp32 channel sums in VMEM scratch across a sequential
// row-tile grid. With b absent, b = a and the pair is (sum x, sum x^2), the
// BatchNorm statistics; with b present it is the BatchNorm backward's
// (sum g, sum g*x).
//
// What bounds it: bytes (each input element read once, two or three fp32
// operations each). The design, shared with B3, is the two-pass reduction of
// channel_reduce.cuh: fp32 partials per block into a scratch buffer that the
// caller allocates, then a fixed-order combine. No atomics: the result is the
// same from run to run on a given card.
//
// Inputs: fp32 or bf16, channels_last NCHW / [M, C] (inner = 1) or
// contiguous NCHW (inner = H*W); a and b share dtype and layout.
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include "channel_reduce.cuh"

namespace {

struct SumsOp {
  struct Param {};
  __device__ __forceinline__ Param param(int64_t) const { return {}; }
  __device__ __forceinline__ void apply(const Param&, float a, float b, float& u,
                                        float& v) const {
    u = a;
    v = a * b;
  }
};

template <typename T>
int dispatch(const void* a, const void* b, long long numel, long long inner, long long channels,
             bool aligned, float* scratch, long long max_parts, float* out_s, float* out_q,
             cudaStream_t stream) {
  if (b != nullptr) {
    return chred::launch_reduce<T, true>(a, b, numel, inner, channels, aligned, SumsOp{}, scratch,
                                         max_parts, out_s, out_q, stream);
  }
  return chred::launch_reduce<T, false>(a, nullptr, numel, inner, channels, aligned, SumsOp{},
                                        scratch, max_parts, out_s, out_q, stream);
}

}  // namespace

// b may be null (single form). dtype: 0 = float32, 1 = bfloat16. scratch:
// 2 * max_parts * channels floats. aligned: a (and b) are 16-byte aligned.
// out_s, out_q: [channels] float32. Returns a cudaError_t.
extern "C" int channel_sums_launch(const void* a, const void* b, void* out_s, void* out_q,
                                   void* scratch, long long max_parts, long long numel,
                                   long long inner, long long channels, int dtype, int aligned,
                                   void* stream) {
  if (numel <= 0 || inner <= 0 || channels <= 0 || max_parts <= 0 || max_parts > 65535 ||
      numel % (inner * channels) != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* s = static_cast<float*>(out_s);
  float* q = static_cast<float*>(out_q);
  float* work = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(a, b, numel, inner, channels, aligned != 0, work, max_parts, s, q, st);
  }
  return dispatch<__nv_bfloat16>(a, b, numel, inner, channels, aligned != 0, work, max_parts, s,
                                 q, st);
}
