// Fused PE + per-link attention over the classic class-blocked context
// table, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/pe_attention.py:
// _fwd_kernel (:81) behind _fwd_call (:156), reached from the public
// fused_pe_link_attention (:515).
//
// The table's C columns are K <= 3 contiguous class blocks [cn | 1-hop |
// >1-hop] of widths n0, n1, n2. The TPU kernel tiles C so that every tile
// holds one class and streams that class's weights per tile, which needs
// widths that one tile size divides (the JAX package falls back to XLA
// otherwise). Here the kernel is csrc/pe_attention_fwd.cuh's template (its
// math, bound and design are described there) with BlockedClasses: a
// slot's class is the block that holds its column, found from the block
// ends passed by value. It takes any widths; no [B, C] class tensor is
// built or read. A 32-slot ballot chunk may straddle two blocks, so each
// lane finds its own slot's class, and the valid slots need not be a
// prefix of their block. One link's softmax spans all its blocks, so a
// link's whole row stays in one warp.

#include "pe_attention_fwd.cuh"

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// n0, n1, n2: the class blocks' widths (0 past K), summing to C. bf16 != 0:
// keys and w2f are bfloat16, else float32. Everything else is float32,
// except valid (uint8/bool).
int pe_attention_fwd(const void* keys, const void* ps, const void* pt,
                     const void* valid, const void* q, const void* w1,
                     const void* b1, const void* g, const void* bln,
                     const void* w2f, const void* cbias, const void* att,
                     const void* bias, void* out, void* m_out, void* l_out,
                     int B, int C, int O, int dh, int K, int n0, int n1,
                     int n2, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int widths[3] = {n0, n1, n2};
  BlockedClasses cls;
  if (!blocked_classes(K, C, widths, &cls)) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_fwd<__nv_bfloat16>(keys, ps, pt, valid, cls, q, w1, b1, g,
                                     bln, w2f, cbias, att, bias, out, m_out,
                                     l_out, B, C, O, dh, K, s);
  return launch_fwd<float>(keys, ps, pt, valid, cls, q, w1, b1, g, bln, w2f,
                           cbias, att, bias, out, m_out, l_out, B, C, O,
                           dh, K, s);
}

const char* pe_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
