// Fused PE + per-link attention over the combined (class-tagged) context
// table, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/pe_attention_mixed.py:
// _fwd_kernel (:77) behind _fwd_call (:155), reached from the public
// fused_pe_link_attention_mixed (:499).
//
// The kernels are csrc/pe_attention_fwd_tiles.cuh's (their math, bound and
// design are described there): tiles of the valid slots of one class, in
// the order ops/pe_attention_mixed.py:compact_tagged_slots lists them from
// the class tags ecls[b, c] clamped into [0, K), so a link's slots lie in
// up to K runs of the list, one per class, and out takes one f32 atomic
// per column of each run (more where a tile boundary cuts a run). What
// bounds them on an H100 is the bytes they must read (the valid slots' key
// rows and the [B, C] tables), not the tensor cores' products. The TPU
// kernel walks C in tiles per link with an online softmax; here a link's
// softmax spans tiles of several classes, so its statistics come from a
// pass of their own between the two tile passes.

#include "pe_attention_fwd_tiles.cuh"

extern "C" {

// Launch the three kernels on `stream`; returns cudaGetLastError() after
// the launches (0 = ok). keys: the key table, [N', O] read at row ids[b*C
// + c] for slot (b, c) when ids [B, C] int32 is given (dead slots' ids are
// never read), else [B, C, O] (ids null). slots [B*C] int32: the valid
// slots' ids b*C + c in (class, link, column) order; offsets [K+1] int32:
// class k's slots at [offsets[k], offsets[k+1]), on the device; valid
// [B, C] uint8/bool; s [B*C] f32 scratch. ts: slots of a tile, 64 or 32.
// bf16 != 0: keys and w2f are bfloat16, else float32; everything else
// float32.
int pe_attention_mixed_fwd(const void* keys, const void* ids, const void* ps,
                           const void* pt, const void* valid,
                           const void* slots,
                           const void* offsets, const void* q,
                           const void* w1, const void* b1, const void* g,
                           const void* bln, const void* w2f,
                           const void* cbias, const void* att,
                           const void* bias, void* s, void* out, void* m,
                           void* l, int B, int C, int O, int dh, int K,
                           int ts, int bf16, void* stream) {
  auto launch = bf16 ? &launch_tiles_fwd<__nv_bfloat16>
                     : &launch_tiles_fwd<float>;
  return launch(keys, ids, ps, pt, valid, slots, offsets, q, w1, b1, g, bln,
                w2f, cbias, att, bias, s, out, m, l, B, C, O, dh, K, ts,
                (cudaStream_t)stream);
}

const char* pe_attention_mixed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
