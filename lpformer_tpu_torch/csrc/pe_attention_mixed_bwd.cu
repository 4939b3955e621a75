// Fused PE + per-link attention over the combined (class-tagged) context
// table, backward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/pe_attention_mixed.py:
// _bwd_kernel (:250, with _dir_bwd_mixed :221) behind _bwd_call (:366),
// reached from the custom VJP _fused_bwd (:468).
//
// The kernels are csrc/pe_attention_bwd.cuh's templates (their math,
// bound and two-launch design are described there) with TaggedClasses:
// the class of slot (b, c) is ecls[b, c], so the dw2 reduction of class k
// walks every column and keeps the slots tagged k.

#include "pe_attention_bwd.cuh"

extern "C" {

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok). bf16 != 0: keys, w2f and dkeys are bfloat16, else
// float32. valid is uint8/bool, ecls int32, everything else float32.
// dkeys and dq are written in full; dw1cat [3K, dh], dg, db [K, dh],
// dcb [K, O], datt [O] and dw2 [K, dh, O] are summed into and must be
// zeroed by the caller.
int pe_attention_mixed_bwd(
    const void* keys, const void* ps, const void* pt, const void* valid,
    const void* ecls, const void* q, const void* g_out, const void* m,
    const void* l, const void* delta, const void* w1, const void* b1,
    const void* g, const void* bln, const void* w2f, const void* cbias,
    const void* att, void* dkeys, void* dq, void* dw1cat, void* dg,
    void* db, void* dcb, void* datt, void* dw2, int B, int C, int O, int dh,
    int K, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const TaggedClasses cls{(const int32_t*)ecls, K};
  if (bf16)
    return launch_bwd<__nv_bfloat16>(keys, ps, pt, valid, cls, q, g_out, m,
                                     l, delta, w1, b1, g, bln, w2f, cbias,
                                     att, dkeys, dq, dw1cat, dg, db, dcb,
                                     datt, dw2, B, C, O, dh, K, s);
  return launch_bwd<float>(keys, ps, pt, valid, cls, q, g_out, m, l, delta,
                           w1, b1, g, bln, w2f, cbias, att, dkeys, dq,
                           dw1cat, dg, db, dcb, datt, dw2, B, C, O, dh, K,
                           s);
}

const char* pe_attention_mixed_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
