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
//   * one warp per link, lanes own 4 consecutive output columns (O <= 128,
//     dh <= 128, the main path's widths): no block barriers, only warp
//     shuffles; a link's state (running max, sum and the O accumulators)
//     stays in registers. A link's softmax spans all its classes, so its
//     whole row, every class block included, stays in one warp;
//   * valid slots are found 32 at a time with a ballot over the validity
//     row, so a dead slot costs one byte read and its key row, ps/pt and
//     class are never loaded; a fully dead 32-slot chunk costs 32 bytes.
//     A chunk may straddle two classes: each lane finds its own slot's
//     class, and the warp takes it with the slot's ps/pt by shuffle;
//   * all K classes' W2f matrices sit in shared memory (3*128*128 bf16 =
//     96 KB, dynamic shared memory above 48 KB), staged once per block,
//     and a slot's class selects its matrix by index; the blocks are
//     persistent (grid = resident blocks) so the staging is paid per SM,
//     not per link;
//   * both PE directions share one product: sum_d (h_a[d] + h_b[d]) W2f[d,:].
// The per-slot W2f read from shared memory (dh*O elements) is what limits
// the inner loop; batching slots through wgmma is later work.
#pragma once

#include "pe_attention_common.cuh"

namespace {

constexpr int kFwdWarps = 8;            // links in flight per block
constexpr int kFwdThreads = kFwdWarps * 32;

template <typename T, typename Cls>
__global__ void __launch_bounds__(kFwdThreads, 2)
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
    size_t w2_smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* w2s = reinterpret_cast<T*>(smem);                       // [K, dh, O]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* hs = reinterpret_cast<float*>(smem + w2_smem_bytes) + warp * dh;

  const size_t n_w2 = (size_t)K * dh * O;
  for (size_t i = threadIdx.x; i < n_w2; i += kFwdThreads) w2s[i] = w2f[i];
  __syncthreads();

  const int o = 4 * lane;
  const bool own = o < O;
  float attv[4] = {0.f, 0.f, 0.f, 0.f}, biasv[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) {
    load4(att + o, attv);
    load4(bias + o, biasv);
  }

  for (int b = blockIdx.x * kFwdWarps + warp; b < B;
       b += gridDim.x * kFwdWarps) {
    float qv[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (own) load4(q + (size_t)b * O + o, qv);
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

        float x[4] = {0.f, 0.f, 0.f, 0.f};   // becomes xj
        float kv[4] = {0.f, 0.f, 0.f, 0.f};
        if (own) load4(keys + bc * O + o, kv);

        // layer 1 and LayerNorm of both directions
        float xa[kMaxJD], xb[kMaxJD], ra, rb;
        ln_pair(w1, b1, k, dh, lane, a0, a1, xa, xb, ra, rb);
        __syncwarp();  // the previous slot's reads of hs are done
#pragma unroll
        for (int jd = 0; jd < kMaxJD; ++jd) {
          const int d = lane + 32 * jd;
          if (d < dh) {
            const float gg = g[k * dh + d], bn = bln[k * dh + d];
            hs[d] = round_to(fmaxf(xa[jd] * gg + bn, 0.f), T()) +
                    round_to(fmaxf(xb[jd] * gg + bn, 0.f), T());
          }
        }
        __syncwarp();

        // layer 2 (both directions at once) + key + class bias, logit
        float part = 0.f;
        if (own) {
          const T* wk = w2s + (size_t)k * dh * O + o;
#pragma unroll 4
          for (int d = 0; d < dh; ++d) {
            float w[4];
            load4(wk + (size_t)d * O, w);
            const float h = hs[d];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] += h * w[i];
          }
          float cb[4];
          load4(cbias + (size_t)k * O + o, cb);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] += kv[i] + cb[i];
            float z = x[i] * qv[i];
            z = z >= 0.f ? z : 0.2f * z;
            part += attv[i] * z;
          }
        }
        const float s = warp_sum(part);

        // online softmax
        const float m1 = fmaxf(m, s);
        const float corr = expf(m - m1), e = expf(s - m1);
        l = l * corr + e;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = acc[i] * corr + e * x[i];
        m = m1;
      }
    }

    if (own) {
      const float inv = 1.f / fmaxf(l, 1e-16f);
      float4 r;
      r.x = acc[0] * inv + biasv[0];
      r.y = acc[1] * inv + biasv[1];
      r.z = acc[2] * inv + biasv[2];
      r.w = acc[3] * inv + biasv[3];
      *reinterpret_cast<float4*>(out + (size_t)b * O + o) = r;
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
               void* l_out, int B, int C, int O, int dh, int K,
               cudaStream_t stream) {
  if (O % 4 != 0 || O > kMaxO || dh > kMaxDh || K < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t w2_bytes = ((size_t)K * dh * O * sizeof(T) + 15) / 16 * 16;
  const size_t smem = w2_bytes + (size_t)kFwdWarps * dh * sizeof(float);
  auto kern = pe_attention_fwd_kernel<T, Cls>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, kFwdThreads, smem,
                                    (B + kFwdWarps - 1) / kFwdWarps, &grid,
                                    &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kFwdThreads, smem, stream>>>(
      (const T*)keys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)q, (const float*)w1,
      (const float*)b1, (const float*)g, (const float*)bln, (const T*)w2f,
      (const float*)cbias, (const float*)att, (const float*)bias,
      (float*)out, (float*)m_out, (float*)l_out, B, C, O, dh, K, w2_bytes);
  return (int)cudaGetLastError();
}

}  // namespace
