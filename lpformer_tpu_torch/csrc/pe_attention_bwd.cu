// Fused PE + per-link attention over the classic class-blocked context
// table, backward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/pe_attention.py:
// _bwd_kernel (:244, with _dir_bwd :219) behind _bwd_call (:367), reached
// from the custom VJP _fused_bwd (:460).
//
// The kernels are csrc/pe_attention_bwd_tiles.cuh's (their math, bound and
// design are described there): tiles of the valid slots of one class, in
// the order ops/pe_attention_mixed.py:compact_tagged_slots lists them
// (class k is the column block k, widths n0, n1, n2). The TPU kernel sums
// each C-tile's weight grads in scratch across a sequential sweep of the
// links and writes one set per tile, which the wrapper then sums per class
// (its dw2 rounded to bf16 per tile first, pe_attention.py:485). Here the
// small grads go through per-block shared-memory sums and one f32 atomic
// per element and block, and the dw2 launch reduces class k over its
// slots alone, in f32, rounded once by the caller. Dead slots' dkeys rows
// are zero, as on the TPU (:336-339): the caller zeroes dkeys and the
// kernels write the valid rows.

#include "pe_attention_bwd_tiles.cuh"

extern "C" {

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok). keys: the key table, [N', O] read at row ids[b*C +
// c] for slot (b, c) when ids [B, C] int32 is given (dead slots' ids are
// never read), else [B, C, O] (ids null); dkeys is [B, C, O] either way.
// slots [B*C] int32: the valid slots' ids b*C + c in (class, link,
// column) order; offsets [K+1] int32: class k's slots at [offsets[k],
// offsets[k+1]), on the device. n0, n1, n2: the class blocks' widths (0
// past K), summing to C. ts: slots of a tile, 64 or 32. bf16 != 0: keys,
// w2f and dkeys are bfloat16, else float32; everything else float32.
// dkeys, dq [B, O], dw1cat [3K, dh], dg, db [K, dh], dcb [K, O], datt [O]
// and dw2 [K, dh, O] are summed into and must be zeroed by the caller.
int pe_attention_bwd(
    const void* keys, const void* ids, const void* ps, const void* pt,
    const void* slots, const void* offsets, const void* q,
    const void* g_out, const void* m, const void* l, const void* delta,
    const void* w1, const void* b1, const void* g, const void* bln,
    const void* w2f, const void* cbias, const void* att, void* dkeys,
    void* dq, void* dw1cat, void* dg, void* db, void* dcb, void* datt,
    void* dw2, int B, int C, int O, int dh, int K,
    int n0, int n1, int n2, int ts, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int widths[3] = {n0, n1, n2};
  if (!class_widths_ok(K, C, widths)) return (int)cudaErrorInvalidValue;
  auto launch = bf16 ? &launch_tiles_bwd<__nv_bfloat16>
                     : &launch_tiles_bwd<float>;
  return launch(keys, ids, ps, pt, slots, offsets, q, g_out, m, l, delta,
                w1, b1, g, bln, w2f, cbias, att, dkeys, dq, dw1cat, dg, db,
                dcb, datt, dw2, B, C, O, dh, K, ts, s);
}

const char* pe_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
