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
// otherwise). Here the kernels are csrc/pe_attention_fwd_tiles.cuh's (their
// math, bound and design are described there): tiles of the valid slots
// of one class, in the order ops/pe_attention_mixed.py:compact_tagged_slots
// lists them from each column's block (class k is the column block k), so
// any widths are taken and the valid slots need not be a prefix of their
// block. What bounds them on an H100 is the bytes they must read (the
// valid slots' key rows and the [B, C] tables), not the tensor cores'
// products. A link's softmax spans its blocks, so its statistics come from
// a pass of their own between the two tile passes.

#include "pe_attention_fwd_tiles.cuh"

extern "C" {

// Launch the three kernels on `stream`; returns cudaGetLastError() after
// the launches (0 = ok). keys: the key table, [N', O] read at row ids[b*C
// + c] for slot (b, c) when ids [B, C] int32 is given (dead slots' ids are
// never read), else [B, C, O] (ids null). slots [B*C] int32: the valid
// slots' ids b*C + c in (class, link, column) order; offsets [K+1] int32:
// class k's slots at [offsets[k], offsets[k+1]), on the device; valid
// [B, C] uint8/bool; s [B*C] f32 scratch. n0, n1, n2: the class blocks'
// widths (0 past K), summing to C. ts: slots of a tile, 64 or 32. bf16 !=
// 0: keys and w2f are bfloat16, else float32; everything else float32.
int pe_attention_fwd(const void* keys, const void* ids, const void* ps,
                     const void* pt, const void* valid, const void* slots,
                     const void* offsets, const void* q, const void* w1,
                     const void* b1, const void* g, const void* bln,
                     const void* w2f, const void* cbias, const void* att,
                     const void* bias, void* s, void* out, void* m, void* l,
                     int B, int C, int O, int dh, int K, int n0, int n1,
                     int n2, int ts, int bf16, void* stream) {
  const int widths[3] = {n0, n1, n2};
  if (!class_widths_ok(K, C, widths)) return (int)cudaErrorInvalidValue;
  auto launch = bf16 ? &launch_tiles_fwd<__nv_bfloat16>
                     : &launch_tiles_fwd<float>;
  return launch(keys, ids, ps, pt, valid, slots, offsets, q, w1, b1, g, bln,
                w2f, cbias, att, bias, s, out, m, l, B, C, O, dh, K, ts,
                (cudaStream_t)stream);
}

const char* pe_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
