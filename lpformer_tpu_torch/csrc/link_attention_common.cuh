// Device helpers of the per-link attention kernels
// (csrc/link_attention_{fwd,bwd}.cu): a warp takes a link's valid slots up
// to kSlots at a time, stages their key rows in its slice of shared memory
// and forms their xj = keys @ W_r together, so each W_r element read feeds
// kSlots slots. W_r is split by rows (SplitRows): each persistent block
// stages as many leading rows as its shared memory holds beside its warps'
// slices (all of them in bf16 at the A/B's Dk = 256, O = 128) and reads the
// rest through the read-only path.
#pragma once

#include "pe_attention_common.cuh"

namespace {

constexpr int kSlots = 4;               // valid slots whose xj a warp forms

// x[s][0..3] += sum_d ks[s][d] * w[d, o .. o+3] for the group's kSlots
// staged key rows (row stride ks_stride) over W_r's Dk rows (row stride
// O): the rows staged in shared memory, then the rest through the
// read-only path.
template <typename T>
__device__ __forceinline__ void group_product(const SplitRows<T>& w,
                                              const float* ks, int ks_stride,
                                              int Dk, int O, int o, int n,
                                              bool vec, float (*x)[4]) {
  const int split = min(w.staged, Dk);
  if (vec && n == 4) {
#pragma unroll 2
    for (int d = 0; d < split; ++d) {
      float v[4];
      load4_shared(w.shared + (size_t)d * O + o, v);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float kv = ks[s * ks_stride + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[s][i] += kv * v[i];
      }
    }
#pragma unroll 2
    for (int d = split; d < Dk; ++d) {
      float v[4];
      load4(w.global + (size_t)d * O + o, v);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float kv = ks[s * ks_stride + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[s][i] += kv * v[i];
      }
    }
  } else {
    for (int d = 0; d < Dk; ++d) {
      float v[4];
      row4(w, d, O, o, n, vec, v);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float kv = ks[s * ks_stride + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[s][i] += kv * v[i];
      }
    }
  }
}

// The next up to kSlots valid slots of the chunk at c0 (bits of `live`,
// which loses them); returns how many, and their columns in slot[].
__device__ __forceinline__ int take_slots(unsigned& live, int c0,
                                          int* slot) {
  int ns = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    slot[s] = c0;
    if (live) {
      slot[s] = c0 + __ffs(live) - 1;
      live &= live - 1;
      ns = s + 1;
    }
  }
  return ns;
}

// The group's key rows into the warp's ks [kSlots][ks_stride], as f32.
template <typename T>
__device__ __forceinline__ void stage_keys(const T* __restrict__ keys,
                                           size_t row0, const int* slot,
                                           int ns, int Dk, int ks_stride,
                                           int lane, float* ks) {
  const bool kvec = (Dk & 3) == 0;
  for (int s = 0; s < ns; ++s) {
    const T* row = keys + (row0 + slot[s]) * Dk;
    for (int d = 4 * lane; d < Dk; d += kGroup) {
      const int n = min(4, Dk - d);
      float v[4];
      loadn(row + d, n, kvec, v);
      for (int i = 0; i < n; ++i) ks[s * ks_stride + d + i] = v[i];
    }
  }
}

}  // namespace
