// Fused PE + per-link attention, forward pass, for Hopper (sm_90a), as
// class-uniform tiles of compacted valid slots: the kernels behind both
// context-table layouts' forward, csrc/pe_attention_fwd.cu (the classic
// class-blocked table) and csrc/pe_attention_mixed_fwd.cu (the combined
// class-tagged table).
//
// Math, for each link b and each valid slot c of class k:
//   g_k(x) = relu(LN_k(x @ W1_k + b1_k))   (LN eps 1e-5; h = g_k(x) rounded
//            to W2f's type)
//   xj     = keys[b,c] + ha W2f_k + hb W2f_k + cbias_k,  with ha = g_k([ps,
//            pt]) and hb = g_k([pt, ps]) (ps, pt the slot's PPR values)
//   s      = sum_o att[o] lrelu(xj[o] q[b,o]),  lrelu the leaky ReLU (0.2)
//   m[b]   = max_c s,  l[b] = sum_c exp(s - m[b])
//   out[b] = sum_c exp(s - m[b]) / max(l[b], 1e-16) xj + bias
// over the link's valid slots; a link with none gets out = bias, m = -5e29
// and l = 0. As in the TPU kernels, h is rounded to W2f's type (bf16)
// before the W2f products, which accumulate in f32; everything else is
// f32.
//
// What bounds it on an H100: the bytes it must read, the valid slots' key
// rows (O elements each) and the [B, C] validity, PPR and class tables,
// against 3.35 TB/s; the valid slots' dh x O products are microseconds of
// tensor-core time. The tables are front-compacted and mostly dead (about
// 7 valid slots a link of 128 at the collab-like shape, 44 at the
// ddi-like density), so a kernel that walks the dead slots, or that forms
// a slot's product on CUDA cores while a warp waits, is far from it.
//
// Design. The wrapper lists the valid slots in (class, link, column)
// order with the classes' offsets on the device (no host sync), as the
// backward's wrapper does, and the kernels take tiles of TS slots of one
// class (csrc/pe_attention_tiles.cuh). Three launches, none of which reads
// a count back to the host:
//   (i)   logits: per tile the prologue the backward runs (the rows read,
//         [Ha | Hb], X = [Ha | Hb] [W2f_k ; W2f_k] on the tensor cores,
//         keys and cbias, each row's logit), and each slot's s written to
//         an f32 scratch [B C] at its slot id;
//   (ii)  statistics: a warp per link reads its row of the scratch under
//         the validity: m the exact max, l = sum exp(s - m) lane by lane
//         then across the warp, a fixed order; out[b] = bias;
//   (iii) weighted sum: per tile the same prologue again, alpha =
//         exp(s - m) / max(l, 1e-16) as the backward takes it, then a
//         thread per column walks the tile's rows and adds alpha xj into
//         out, one f32 atomic per (run of a link's rows, column).
// xj is recomputed in (iii) rather than saved: a saved copy would need
// either the valid count on the host or a [B C, O] f32 buffer (268 MB at
// the collab-like combined shape). Because (i), (iii) and the backward
// share the prologue, the backward's xj, s and alpha equal the forward's
// bit for bit. out's sums go through f32 atomics, so the order of its
// additions changes from run to run.
#pragma once

#include "pe_attention_tiles.cuh"

namespace {

constexpr int kStatsWarps = 8;          // links a statistics block takes

// (i) kSum false: each valid slot's logit into s [B C]; (iii) kSum true:
// out[b] += alpha xj over the link's valid slots, from m and l.
template <typename T, int TS, bool kSum>
__global__ void __launch_bounds__(32 * tile_warps(TS))
pe_tiles_fwd_kernel(
    const T* __restrict__ keys, const int32_t* __restrict__ ids,
    const float* __restrict__ ps,
    const float* __restrict__ pt, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ offsets, const float* __restrict__ q,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ bln,
    const T* __restrict__ w2f, const float* __restrict__ cbias,
    const float* __restrict__ att, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ s_out,
    float* __restrict__ out, int C, int O, int dh, int K, int dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem L{TS, O, dh, dc, (int)sizeof(T), 0};
  const TilePtrs<T> p(smem_raw, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xs = L.xs();
  const TileList tiles(offsets, K, TS);
  int w_class = -1;     // the class whose W2f sits in wsm

  for (int t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    int k, s0, n;
    tiles.at(t, TS, k, s0, n);
    tile_xj<T, TS>(keys, ids, ps, pt, slots, w1, b1, g, bln, w2f, cbias, L,
                   p, k, s0, n, C, w_class);

    for (int r = warp; r < n; r += tile_warps(TS)) {
      const int b = p.rlink[r];
      float unused;
      const float s = row_logit<false>(p.xd + (size_t)r * xs,
                                       q + (size_t)b * O, att, O, lane,
                                       nullptr, unused);
      if (lane == 0) {
        if (kSum)
          p.rf[kAlpha * TS + r] = softmax_weight(s, m_in[b], l_in[b]);
        else
          s_out[p.rslot[r]] = s;
      }
    }
    if (kSum) {
      __syncthreads();
      // a thread per column walks its share of the rows, summing alpha xj
      // along each link's run
      const int parts = O < (int)blockDim.x ? blockDim.x / O : 1;
      for (int w = threadIdx.x; w < parts * O; w += blockDim.x) {
        const int col = w % O;
        int r0, r1;
        row_split(n, parts, w / O, r0, r1);
        float run = 0.f;
        int prev = -1;
        for (int r = r0; r < r1; ++r) {
          const int b = p.rlink[r];
          if (b != prev) {
            if (prev >= 0) atomicAdd(out + (size_t)prev * O + col, run);
            run = 0.f;
            prev = b;
          }
          run += p.rf[kAlpha * TS + r] * p.xd[(size_t)r * xs + col];
        }
        if (prev >= 0) atomicAdd(out + (size_t)prev * O + col, run);
      }
    }
    __syncthreads();
  }
}

// (ii) a warp per link: m = max s over its valid slots (-5e29 for none),
// l = sum exp(s - m) lane by lane then across the warp, out[b] = bias.
__global__ void __launch_bounds__(32 * kStatsWarps)
pe_fwd_stats_kernel(const uint8_t* __restrict__ valid,
                    const float* __restrict__ s,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int B, int C, int O) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kStatsWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const uint8_t* v = valid + (size_t)b * C;
  const float* sb = s + (size_t)b * C;
  float m = kNeg / 2;
  for (int c = lane; c < C; c += 32)
    if (v[c]) m = fmaxf(m, sb[c]);
  m = warp_max(m);
  float l = 0.f;
  for (int c = lane; c < C; c += 32)
    if (v[c]) l += expf(sb[c] - m);
  l = warp_sum(l);
  for (int o = lane; o < O; o += 32) out[(size_t)b * O + o] = bias[o];
  if (lane == 0) {
    m_out[b] = m;
    l_out[b] = l;
  }
}

// The three launches with tiles of TS slots on `stream`; returns
// cudaGetLastError() after them (0 = ok).
template <typename T, int TS>
int launch_fwd(const void* keys, const void* ids, const void* ps,
               const void* pt,
               const void* valid, const void* slots, const void* offsets,
               const void* q, const void* w1, const void* b1, const void* g,
               const void* bln, const void* w2f, const void* cbias,
               const void* att, const void* bias, void* s, void* out,
               void* m, void* l, int B, int C, int O, int dh, int K,
               cudaStream_t stream) {
  const long long slots_n = (long long)B * C;
  for (int pass = 0; pass < 2; ++pass) {
    auto kern = pass ? pe_tiles_fwd_kernel<T, TS, true>
                     : pe_tiles_fwd_kernel<T, TS, false>;
    TileLaunch t;
    cudaError_t err =
        tile_launch(kern, TS, O, dh, K, (int)sizeof(T), 0, slots_n, &t);
    if (err != cudaSuccess) return (int)err;
    kern<<<t.grid, 32 * tile_warps(TS), t.smem, stream>>>(
        (const T*)keys, (const int32_t*)ids, (const float*)ps,
        (const float*)pt, (const int32_t*)slots, (const int32_t*)offsets,
        (const float*)q, (const float*)w1, (const float*)b1, (const float*)g,
        (const float*)bln, (const T*)w2f, (const float*)cbias,
        (const float*)att, (const float*)m, (const float*)l, (float*)s,
        (float*)out, C, O, dh, K, t.L.dc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (pass == 0) {
      pe_fwd_stats_kernel<<<(B + kStatsWarps - 1) / kStatsWarps,
                            32 * kStatsWarps, 0, stream>>>(
          (const uint8_t*)valid, (const float*)s, (const float*)bias,
          (float*)out, (float*)m, (float*)l, B, C, O);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// Tiles of `ts` slots, 64 or 32 (ops/pe_attention_mixed.py:tile_slots, as
// the backward). T = keys' and w2f's type; everything else is float32,
// valid uint8, ids (null, or [B C] key rows), slots and offsets int32.
template <typename T>
int launch_tiles_fwd(const void* keys, const void* ids, const void* ps,
                     const void* pt,
                     const void* valid, const void* slots,
                     const void* offsets, const void* q, const void* w1,
                     const void* b1, const void* g, const void* bln,
                     const void* w2f, const void* cbias, const void* att,
                     const void* bias, void* s, void* out, void* m, void* l,
                     int B, int C, int O, int dh, int K, int ts,
                     cudaStream_t stream) {
  if (O < 1 || dh < 1 || K < 1 || K > 3 || (ts != 64 && ts != 32))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto launch = ts == 64 ? &launch_fwd<T, 64> : &launch_fwd<T, 32>;
  return launch(keys, ids, ps, pt, valid, slots, offsets, q, w1, b1, g, bln,
                w2f, cbias, att, bias, s, out, m, l, B, C, O, dh, K, stream);
}

}  // namespace
