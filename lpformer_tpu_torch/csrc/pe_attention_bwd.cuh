// Fused PE + per-link attention, backward pass, for Hopper (sm_90a): the
// kernel templates behind csrc/pe_attention_mixed_bwd.cu (the combined
// table, class per slot) and csrc/pe_attention_bwd.cu (the classic table,
// class per column block). `Cls` says where a slot's class comes from
// (csrc/pe_attention_common.cuh).
//
// Recomputes each valid slot's forward from the saved softmax statistics
// m, l (as csrc/pe_attention_fwd.cuh computes it), then, with g_out [B, O]
// and delta[b] = g_out[b] . (out[b] - bias):
//   alpha  = exp(s - m) / max(l, 1e-16)         (0 on dead slots)
//   dlogit = alpha * (g_out . xj - delta)
//   dxj    = alpha g_out + dlogit att lrelu'(xj q) q
//   dkeys  = dxj in the keys' type (0 on dead slots);  dq = sum_c dlogit..
//   datt  += dlogit lrelu(xj q);  dcb_k += dxj
//   dxjc   = dxj rounded to W2f's type;  hk = h rounded to W2f's type
//   dw2_k += (hk_a + hk_b)^T dxjc;  dh = dxjc W2f_k^T (both directions)
//   then the ReLU and LayerNorm backward of each direction into the grads
//   of g_k, b_k and the packed layer-1 rows (w1a_k | w1b_k | b1_k).
// The rounding points are the TPU kernels': hk and dxjc in W2f's type,
// everything else f32.
//
// What bounds it on an H100: the bytes of dkeys. Every slot's row must be
// written (zeros on the dead slots, most of the table), against a few MB
// of valid key rows read; the valid slots' three dh*O products are a few
// microseconds of tensor-core time. Design, in two launches:
//   * main kernel, one warp per link as in the forward: lanes own 4
//     output columns and 4 hidden units; a ballot over the validity row
//     finds the valid slots (dead ones get their zero row and nothing
//     else); W2f of every class sits in shared memory (96 KB bf16); the
//     per-class grads of g, b, the layer-1 rows, cbias and att are summed
//     per block with shared-memory atomics and flushed once per block with
//     one global f32 atomicAdd per element and block (the TPU carries them
//     in scratch through its sequential grid; blocks here run in parallel).
//     dh = dxjc W2f_k^T reads W2f rows with a per-lane rotated start, so
//     the 32 lanes hit 32 different banks.
//   * dw2 kernel: dw2 is K*dh*O = 49,152 f32 sums (192 KB), too big for
//     shared memory beside W2f, so a second launch reduces it by class and
//     32-column slab: block (chunk, k, slab) walks its links' valid slots
//     of class k over the columns class k may hold (all of them for the
//     combined table, only its block for the classic one), recomputes
//     hk_a + hk_b from (ps, pt) (a LayerNorm over dh, no W2f product),
//     reads dxjc back from dkeys (dkeys is dxj in the keys' type, which is
//     W2f's type: the same rounding), and accumulates the outer product in
//     registers, one column per lane; blocks then add into shared memory
//     and flush with one global atomicAdd per element.
// Every sum across warps and blocks goes through f32 atomics, so the order
// of the additions changes from run to run.
#pragma once

#include "pe_attention_common.cuh"

namespace {

constexpr int kBwdWarps = 16;           // links in flight per block
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kDw2Warps = 8;            // dw2 kernel
constexpr int kDw2Threads = kDw2Warps * 32;

template <typename T, typename Cls>
__global__ void __launch_bounds__(kBwdThreads, 1)
pe_attention_bwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ ps,
    const float* __restrict__ pt, const uint8_t* __restrict__ valid,
    const Cls cls, const float* __restrict__ q,
    const float* __restrict__ g_out, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ delta_in,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ bln,
    const T* __restrict__ w2f, const float* __restrict__ cbias,
    const float* __restrict__ att, T* __restrict__ dkeys,
    float* __restrict__ dq, float* __restrict__ dw1cat,
    float* __restrict__ dg, float* __restrict__ db,
    float* __restrict__ dcb, float* __restrict__ datt, int B, int C, int O,
    int dh, int K, size_t w2_smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* w2s = reinterpret_cast<T*>(smem);                      // [K, dh, O]
  float* acc_w1 = reinterpret_cast<float*>(smem + w2_smem_bytes);  // [3K, dh]
  float* acc_g = acc_w1 + 3 * K * dh;                       // [K, dh]
  float* acc_b = acc_g + K * dh;                            // [K, dh]
  float* acc_cb = acc_b + K * dh;                           // [K, O]
  float* acc_att = acc_cb + K * O;                          // [O]
  const int n_acc = 5 * K * dh + K * O + O;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* hs = acc_att + O + warp * (dh + O);                // [dh]
  float* dx = hs + dh;                                      // [O]

  const size_t n_w2 = (size_t)K * dh * O;
  for (size_t i = threadIdx.x; i < n_w2; i += kBwdThreads) w2s[i] = w2f[i];
  for (int i = threadIdx.x; i < n_acc; i += kBwdThreads) acc_w1[i] = 0.f;
  __syncthreads();

  const int o = 4 * lane;
  const bool own = o < O;
  const float zero4[4] = {0.f, 0.f, 0.f, 0.f};
  float attv[4] = {0.f, 0.f, 0.f, 0.f}, datt_acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) load4(att + o, attv);

  for (int b = blockIdx.x * kBwdWarps + warp; b < B;
       b += gridDim.x * kBwdWarps) {
    float qv[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
    float dqa[4] = {0.f, 0.f, 0.f, 0.f};
    if (own) {
      load4(q + (size_t)b * O + o, qv);
      load4(g_out + (size_t)b * O + o, gv);
    }
    const float m = m_in[b], lc = fmaxf(l_in[b], 1e-16f), dl = delta_in[b];

    for (int c0 = 0; c0 < C; c0 += 32) {
      const int cl = c0 + lane;
      const size_t bcl = (size_t)b * C + cl;
      const bool inr = cl < C;
      const bool v = inr && valid[bcl];
      unsigned dead = __ballot_sync(kFull, inr && !v);
      while (dead) {       // dead slots: zero rows, nothing else
        const int bit = __ffs(dead) - 1;
        dead &= dead - 1;
        if (own) store4(dkeys + ((size_t)b * C + c0 + bit) * O + o, zero4);
      }
      unsigned live = __ballot_sync(kFull, v);
      if (!live) continue;
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

        float kv[4] = {0.f, 0.f, 0.f, 0.f};
        if (own) load4(keys + bc * O + o, kv);

        // forward recompute: LayerNorm of both directions, h rounded to
        // W2f's type, one product with (h_a + h_b)
        float xa[kMaxJD], xb[kMaxJD], ra, rb;
        ln_pair(w1, b1, k, dh, lane, a0, a1, xa, xb, ra, rb);
        __syncwarp();  // the previous slot's reads of hs and dx are done
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

        float x[4] = {0.f, 0.f, 0.f, 0.f};
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        float part = 0.f, gpart = 0.f;
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
            const float pre = x[i] * qv[i];
            z[i] = pre >= 0.f ? pre : 0.2f * pre;
            part += attv[i] * z[i];
            gpart += gv[i] * x[i];
          }
        }
        const float s = warp_sum(part);
        const float galpha = warp_sum(gpart);
        const float alpha = expf(s - m) / lc;
        const float dlog = alpha * (galpha - dl);

        // attention backward: dxj, dq, datt, dcb, dkeys
        if (own) {
          float dxj[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            datt_acc[i] += dlog * z[i];
            const float slope = x[i] * qv[i] >= 0.f ? 1.f : 0.2f;
            const float dpre = dlog * attv[i] * slope;
            dxj[i] = alpha * gv[i] + dpre * qv[i];
            dqa[i] += dpre * x[i];
            atomicAdd(acc_cb + k * O + o + i, dxj[i]);
            dx[o + i] = round_to(dxj[i], T());
          }
          store4(dkeys + bc * O + o, dxj);
        }
        __syncwarp();

        // dh = dxjc W2f_k^T (the same for both directions), then the ReLU
        // and LayerNorm backward of each direction
        float dxa[kMaxJD], dxb[kMaxJD];
        float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
        for (int jd = 0; jd < kMaxJD; ++jd) {
          const int d = lane + 32 * jd;
          dxa[jd] = dxb[jd] = 0.f;
          if (d < dh) {
            const float dhh =
                row_dot(w2s + ((size_t)k * dh + d) * O, dx, O, lane);
            const float gg = g[k * dh + d], bn = bln[k * dh + d];
            const float dya = xa[jd] * gg + bn > 0.f ? dhh : 0.f;
            const float dyb = xb[jd] * gg + bn > 0.f ? dhh : 0.f;
            atomicAdd(acc_g + k * dh + d, dya * xa[jd] + dyb * xb[jd]);
            atomicAdd(acc_b + k * dh + d, dya + dyb);
            dxa[jd] = dya * gg;
            dxb[jd] = dyb * gg;
            s1a += dxa[jd];
            s2a += dxa[jd] * xa[jd];
            s1b += dxb[jd];
            s2b += dxb[jd] * xb[jd];
          }
        }
        const float m1a = warp_sum(s1a) / dh, m2a = warp_sum(s2a) / dh;
        const float m1b = warp_sum(s1b) / dh, m2b = warp_sum(s2b) / dh;
#pragma unroll
        for (int jd = 0; jd < kMaxJD; ++jd) {
          const int d = lane + 32 * jd;
          if (d < dh) {
            const float dpa = ra * (dxa[jd] - m1a - xa[jd] * m2a);
            const float dpb = rb * (dxb[jd] - m1b - xb[jd] * m2b);
            // layer-1 input rows: direction a sees (ps, pt, 1), b (pt, ps, 1)
            atomicAdd(acc_w1 + k * dh + d, a0 * dpa + a1 * dpb);
            atomicAdd(acc_w1 + (K + k) * dh + d, a1 * dpa + a0 * dpb);
            atomicAdd(acc_w1 + (2 * K + k) * dh + d, dpa + dpb);
          }
        }
      }
    }
    if (own) store4(dq + (size_t)b * O + o, dqa);
  }

  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) atomicAdd(acc_att + o + i, datt_acc[i]);
  }
  __syncthreads();
  // one global atomic per element and block
  for (int i = threadIdx.x; i < 3 * K * dh; i += kBwdThreads)
    atomicAdd(dw1cat + i, acc_w1[i]);
  for (int i = threadIdx.x; i < K * dh; i += kBwdThreads) {
    atomicAdd(dg + i, acc_g[i]);
    atomicAdd(db + i, acc_b[i]);
  }
  for (int i = threadIdx.x; i < K * O; i += kBwdThreads)
    atomicAdd(dcb + i, acc_cb[i]);
  for (int i = threadIdx.x; i < O; i += kBwdThreads)
    atomicAdd(datt + i, acc_att[i]);
}

// dw2[k] = sum over valid slots of class k of (hk_a + hk_b)^T dxjc, for
// block (chunk, k * nslab + slab): columns slab*32 .. slab*32+31.
template <typename T, typename Cls>
__global__ void __launch_bounds__(kDw2Threads, 1)
pe_attention_dw2_kernel(
    const T* __restrict__ dkeys, const float* __restrict__ ps,
    const float* __restrict__ pt, const uint8_t* __restrict__ valid,
    const Cls cls, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ g,
    const float* __restrict__ bln, float* __restrict__ dw2, int B, int C,
    int O, int dh, int nslab) {
  __shared__ __align__(16) float hsb[kDw2Warps][kMaxDh];
  __shared__ float accs[kMaxDh][32];
  const int k = blockIdx.y / nslab, slab = blockIdx.y % nslab;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = slab * 32 + lane;
  const bool own = col < O;
  const int c_lo = cls.begin(k), c_hi = cls.end(k, C);
  for (int i = threadIdx.x; i < kMaxDh * 32; i += kDw2Threads)
    (&accs[0][0])[i] = 0.f;
  __syncthreads();

  float acc[kMaxDh];
#pragma unroll
  for (int d = 0; d < kMaxDh; ++d) acc[d] = 0.f;
  float* h = hsb[warp];

  for (int b = blockIdx.x * kDw2Warps + warp; b < B;
       b += gridDim.x * kDw2Warps) {
    for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
      const int cl = c0 + lane;
      const size_t bcl = (size_t)b * C + cl;
      const bool v = cl < c_hi && valid[bcl] && cls.holds(bcl, cl, k);
      unsigned live = __ballot_sync(kFull, v);
      if (!live) continue;
      const float ps_l = v ? ps[bcl] : 0.f;
      const float pt_l = v ? pt[bcl] : 0.f;
      while (live) {
        const int bit = __ffs(live) - 1;
        live &= live - 1;
        const float a0 = __shfl_sync(kFull, ps_l, bit);
        const float a1 = __shfl_sync(kFull, pt_l, bit);
        const size_t bc = (size_t)b * C + c0 + bit;
        float xa[kMaxJD], xb[kMaxJD], ra, rb;
        ln_pair(w1, b1, k, dh, lane, a0, a1, xa, xb, ra, rb);
        __syncwarp();  // the previous slot's reads of h are done
#pragma unroll
        for (int jd = 0; jd < kMaxJD; ++jd) {
          const int d = lane + 32 * jd;
          float hv = 0.f;
          if (d < dh) {
            const float gg = g[k * dh + d], bn = bln[k * dh + d];
            hv = round_to(fmaxf(xa[jd] * gg + bn, 0.f), T()) +
                 round_to(fmaxf(xb[jd] * gg + bn, 0.f), T());
          }
          h[d] = hv;
        }
        __syncwarp();
        const float dk = own ? to_f32(dkeys[bc * O + col]) : 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kMaxDh / 4; ++d4) {
          if (4 * d4 < dh) {
            const float4 h4 = *reinterpret_cast<const float4*>(h + 4 * d4);
            acc[4 * d4] += h4.x * dk;
            acc[4 * d4 + 1] += h4.y * dk;
            acc[4 * d4 + 2] += h4.z * dk;
            acc[4 * d4 + 3] += h4.w * dk;
          }
        }
      }
    }
  }

#pragma unroll
  for (int d = 0; d < kMaxDh; ++d)
    if (d < dh) atomicAdd(&accs[d][lane], acc[d]);
  __syncthreads();
  for (int i = threadIdx.x; i < dh * 32; i += kDw2Threads) {
    const int d = i >> 5, c = slab * 32 + (i & 31);
    if (c < O) atomicAdd(dw2 + ((size_t)k * dh + d) * O + c, accs[d][i & 31]);
  }
}

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok). T = keys', w2f's and dkeys' type; valid is uint8,
// everything else float32. dkeys and dq are written in full; dw1cat
// [3K, dh], dg, db [K, dh], dcb [K, O], datt [O] and dw2 [K, dh, O] are
// summed into and must be zeroed by the caller.
template <typename T, typename Cls>
int launch_bwd(const void* keys, const void* ps, const void* pt,
               const void* valid, const Cls& cls, const void* q,
               const void* g_out, const void* m, const void* l,
               const void* delta, const void* w1, const void* b1,
               const void* g, const void* bln, const void* w2f,
               const void* cbias, const void* att, void* dkeys, void* dq,
               void* dw1cat, void* dg, void* db, void* dcb, void* datt,
               void* dw2, int B, int C, int O, int dh, int K,
               cudaStream_t stream) {
  if (O % 4 != 0 || O > kMaxO || dh > kMaxDh || K < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t w2_bytes = ((size_t)K * dh * O * sizeof(T) + 15) / 16 * 16;
  const size_t smem =
      w2_bytes + sizeof(float) * ((size_t)5 * K * dh + (size_t)K * O + O +
                                  (size_t)kBwdWarps * (dh + O));
  auto kern = pe_attention_bwd_kernel<T, Cls>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, kBwdThreads, smem,
                                    (B + kBwdWarps - 1) / kBwdWarps, &grid,
                                    &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kBwdThreads, smem, stream>>>(
      (const T*)keys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)q, (const float*)g_out,
      (const float*)m, (const float*)l, (const float*)delta,
      (const float*)w1, (const float*)b1, (const float*)g,
      (const float*)bln, (const T*)w2f, (const float*)cbias,
      (const float*)att, (T*)dkeys, (float*)dq, (float*)dw1cat, (float*)dg,
      (float*)db, (float*)dcb, (float*)datt, B, C, O, dh, K, w2_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dw2: about two waves of blocks over (link chunk, class, column slab)
  const int nslab = (O + 31) / 32;
  const int ky = K * nslab;
  int nchunk = (2 * sms + ky - 1) / ky;
  const int max_chunk = (B + kDw2Warps - 1) / kDw2Warps;
  if (nchunk > max_chunk) nchunk = max_chunk;
  if (nchunk < 1) nchunk = 1;
  pe_attention_dw2_kernel<T, Cls><<<dim3(nchunk, ky), kDw2Threads, 0,
                                    stream>>>(
      (const T*)dkeys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)w1, (const float*)b1,
      (const float*)g, (const float*)bln, (float*)dw2, B, C, O, dh, nslab);
  return (int)cudaGetLastError();
}

}  // namespace
