// Fused PE + per-link attention over the combined (class-tagged) context
// table, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/pe_attention_mixed.py:
// _fwd_kernel (:77) behind _fwd_call (:155), reached from the public
// fused_pe_link_attention_mixed (:499).
//
// The kernel is csrc/pe_attention_fwd.cuh's template (its math, bound and
// design are described there) with TaggedClasses: the class of slot
// (b, c) is ecls[b, c], so classes mix freely within a link's row.

#include "pe_attention_fwd.cuh"

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// bf16 != 0: keys and w2f are bfloat16, else float32. Everything else is
// float32, except valid (uint8/bool) and ecls (int32).
int pe_attention_mixed_fwd(const void* keys, const void* ps, const void* pt,
                           const void* valid, const void* ecls,
                           const void* q, const void* w1, const void* b1,
                           const void* g, const void* bln, const void* w2f,
                           const void* cbias, const void* att,
                           const void* bias, void* out, void* m_out,
                           void* l_out, int B, int C, int O, int dh,
                           int K, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const TaggedClasses cls{(const int32_t*)ecls, K};
  if (bf16)
    return launch_fwd<__nv_bfloat16>(keys, ps, pt, valid, cls, q, w1, b1, g,
                                     bln, w2f, cbias, att, bias, out, m_out,
                                     l_out, B, C, O, dh, K, s);
  return launch_fwd<float>(keys, ps, pt, valid, cls, q, w1, b1, g, bln, w2f,
                           cbias, att, bias, out, m_out, l_out, B, C, O,
                           dh, K, s);
}

const char* pe_attention_mixed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
