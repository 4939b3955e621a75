// Fused PE + per-link attention, forward pass, for Hopper (sm_90a): the
// kernel template behind csrc/pe_attention_mixed_fwd.cu (the combined
// table, class per slot) and csrc/pe_attention_fwd.cu (the classic table,
// class per column block). `Cls` says where a slot's class comes from
// (csrc/pe_attention_common.cuh).
//
// For each link b and each VALID slot c, with class k = cls.of(b, c):
//   g_k(x) = relu(LN_k(x @ W1_k + b1_k)) @ W2f_k      (LN eps 1e-5)
//   xj     = keys[b,c] + g_k([ps,pt]) + g_k([pt,ps]) + cbias_k
//   s      = sum_o att[o] * leaky_relu_0.2(xj[o] * q[b,o])
//   out[b] = sum_c softmax_c(s) xj / max(l, 1e-16) + bias   (online softmax)
// and the softmax statistics m[b] (running max, -5e29 for a link with no
// valid slot) and l[b] (sum of exp(s - m)). A link with no valid slot
// gets out = bias. As in the TPU kernels, the hidden activation h is
// rounded to the weight type (bf16) before the W2f product, which
// accumulates in f32; everything else is f32.
//
// What bounds it on an H100: the bytes it must read. The tables are
// front-compacted and mostly dead (p50 about 1-2 valid slots a link), so
// the work is the valid slots' key rows (O bf16 each) plus the [B, C]
// tables (valid, and the valid slots' ps/pt), against 3.35 TB/s; the
// per-slot product is 2*dh*O flops, far below the tensor-core roofline.
// What the design does about it:
//   * one warp per link, for any O and dh: lanes own 4 output columns per
//     group of 128 and the hidden units lane + 32*j; past the staging
//     below, no block barriers, only warp shuffles. A link's softmax spans
//     all its classes, so its whole row, every class block included, stays
//     in one warp. The link's running sums over O and the slot's xj sit in
//     the warp's slice of shared memory, each lane touching only its own
//     columns;
//   * valid slots are found 32 at a time with a ballot over the validity
//     row, so a dead slot costs one byte read and its key row, ps/pt and
//     class are never loaded; a fully dead 32-slot chunk costs 32 bytes.
//     A chunk may straddle two classes: each lane finds its own slot's
//     class, and the warp takes it with the slot's ps/pt by shuffle;
//   * W2f (K x dh x O: 96 KB in bf16 at 128, 768 KB in f32 at 256, past
//     the 227 KB a block may hold) is split by rows at every width: each
//     persistent block stages the leading rows of every class's matrix in
//     shared memory, as many as fit beside its warps' slices (all of them
//     at the collab-like widths in bf16), and reads the rest through the
//     read-only path, hot in L2; the warp reads 128 consecutive columns of
//     a row at once. A slot's class selects its matrix;
//   * both PE directions share one product: sum_d (h_a[d] + h_b[d]) W2f[d,:];
//   * the kernel's time is set by its longest chains of slots, so warps
//     draw links from a work counter as they finish (next_link) instead of
//     a fixed stride that could hand one warp two full links.
// The per-slot W2f read (dh*O elements) is what limits the inner loop;
// batching slots through wgmma is later work.
#pragma once

#include "pe_attention_common.cuh"

namespace {

constexpr int kFwdWarps = 16;           // links in flight per block (at most)
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdBlocks = 1;           // resident blocks per SM

// floats of a warp's slice of shared memory: hs [dh], the LayerNorm's
// units past the registers (two of smem_units(dh)), xs, acc [O], each
// 16-byte aligned
__host__ __device__ constexpr size_t fwd_slice(int dh, int O) {
  return (size_t)pad4(dh) + 2 * (size_t)smem_units(dh) + 2 * (size_t)pad4(O);
}

template <typename T, typename Cls>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
pe_attention_fwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ ps,
    const float* __restrict__ pt, const uint8_t* __restrict__ valid,
    const Cls cls, const float* __restrict__ q,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ bln,
    const T* __restrict__ w2f, const float* __restrict__ cbias,
    const float* __restrict__ att, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int C, int O, int dh, int K,
    int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the K classes' leading `staged` W2f rows [K, staged, O], then the
  // warps' slices
  T* w2s = reinterpret_cast<T*>(smem_raw);
  float* smem = reinterpret_cast<float*>(
      smem_raw + staged_bytes(K, staged, O, sizeof(T)));
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's slice: hs [dh] (h_a + h_b, read by every lane), the
  // LayerNorm's units past the registers (own units), xs [O] (the slot's
  // xj), acc [O] (the link's weighted sum; own columns)
  float* hs = smem + (size_t)warp * fwd_slice(dh, O);
  LnPair ln;
  ln.sa = hs + pad4(dh);
  ln.sb = ln.sa + smem_units(dh);
  float* xs = ln.sb + smem_units(dh);
  float* acc = xs + pad4(O);
  const bool vec = (O & 3) == 0;
  stage_rows(w2f, w2s, K, dh, staged, O);
  __syncthreads();

  for (int b = next_link(lane, B); b < B; b = next_link(lane, B)) {
    const float zero4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int o = 4 * lane; o < O; o += kGroup)
      sts4(acc + o, min(4, O - o), vec, zero4);
    float m = kNeg / 2, l = 0.f;

    for (int c0 = 0; c0 < C; c0 += 32) {
      const int cl = c0 + lane;
      const size_t bcl = (size_t)b * C + cl;
      const bool v = cl < C && valid[bcl];
      unsigned live = __ballot_sync(kFull, v);
      if (!live) continue;
      // this lane's slot, loaded only when valid; shuffled out below
      const float ps_l = v ? ps[bcl] : 0.f;
      const float pt_l = v ? pt[bcl] : 0.f;
      const int k_l = v ? cls.of(bcl, cl) : 0;

      while (live) {
        const int bit = __ffs(live) - 1;
        live &= live - 1;
        const int k = __shfl_sync(kFull, k_l, bit);
        const float a0 = __shfl_sync(kFull, ps_l, bit);
        const float a1 = __shfl_sync(kFull, pt_l, bit);
        const size_t bc = (size_t)b * C + c0 + bit;

        // layer 1 and LayerNorm of both directions
        ln.compute(w1, b1, k, dh, lane, a0, a1);
        __syncwarp();  // the previous slot's reads of hs are done
        ln.each(dh, lane, [&](int d, float& xa, float& xb) {
          const float gg = g[k * dh + d], bn = bln[k * dh + d];
          hs[d] = round_to(fmaxf(xa * gg + bn, 0.f), T()) +
                  round_to(fmaxf(xb * gg + bn, 0.f), T());
        });
        __syncwarp();

        // layer 2 (both directions at once) + key + class bias, logit
        float part = 0.f;
        const SplitRows<T> wk = {w2s + (size_t)k * staged * O,
                                 w2f + (size_t)k * dh * O, staged};
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          w2_product(wk, hs, dh, O, o, n, vec, x);
          float kv[4], cb[4], qv[4], av[4];
          loadn(keys + bc * O + o, n, vec, kv);
          loadn(cbias + (size_t)k * O + o, n, vec, cb);
          loadn(q + (size_t)b * O + o, n, vec, qv);
          loadn(att + o, n, vec, av);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] += kv[i] + cb[i];
            float z = x[i] * qv[i];
            z = z >= 0.f ? z : 0.2f * z;
            part += av[i] * z;           // 0 past the row's end
          }
          sts4(xs + o, n, vec, x);
        }
        const float s = warp_sum(part);

        // online softmax
        const float m1 = fmaxf(m, s);
        const float corr = expf(m - m1), e = expf(s - m1);
        l = l * corr + e;
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float a[4], x[4];
          lds4(acc + o, n, vec, a);
          lds4(xs + o, n, vec, x);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = a[i] * corr + e * x[i];
          sts4(acc + o, n, vec, a);
        }
        m = m1;
      }
    }

    const float inv = 1.f / fmaxf(l, 1e-16f);
    for (int o = 4 * lane; o < O; o += kGroup) {
      const int n = min(4, O - o);
      float bv[4], r[4];
      loadn(bias + o, n, vec, bv);
      lds4(acc + o, n, vec, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = r[i] * inv + bv[i];
      storen(out + (size_t)b * O + o, n, vec, r);
    }
    if (lane == 0) {
      m_out[b] = m;
      l_out[b] = l;
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// T = keys' and w2f's type; everything else is float32, valid uint8.
template <typename T, typename Cls>
int launch_fwd(const void* keys, const void* ps, const void* pt,
               const void* valid, const Cls& cls, const void* q,
               const void* w1, const void* b1, const void* g,
               const void* bln, const void* w2f, const void* cbias,
               const void* att, const void* bias, void* out, void* m_out,
               void* l_out, int B, int C, int O, int dh,
               int K, cudaStream_t stream) {
  if (O < 1 || dh < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t per_warp = sizeof(float) * fwd_slice(dh, O);
  const size_t cap = block_smem_cap(kFwdBlocks);
  const int warps = warps_that_fit(kFwdWarps, 0, per_warp, cap);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int staged =
      rows_that_fit(K, dh, O, sizeof(T), warps * per_warp, cap);
  const size_t smem =
      staged_bytes(K, staged, O, sizeof(T)) + warps * per_warp;
  auto kern = pe_attention_fwd_kernel<T, Cls>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, warps * 32, smem, kFwdBlocks,
                                    (B + warps - 1) / warps, &grid, &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)keys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)q, (const float*)w1,
      (const float*)b1, (const float*)g, (const float*)bln, (const T*)w2f,
      (const float*)cbias, (const float*)att, (const float*)bias,
      (float*)out, (float*)m_out, (float*)l_out, B, C, O, dh, K,
      staged);
  return (int)cudaGetLastError();
}

}  // namespace
