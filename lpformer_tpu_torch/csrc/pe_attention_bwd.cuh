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
// microseconds of tensor-core time. Design, in two launches, for any O
// and dh:
//   * main kernel, one warp per link as in the forward: lanes own 4
//     output columns per group of 128 and the hidden units lane + 32*j; a
//     ballot over the validity row finds the valid slots (dead ones get
//     their zero row and nothing else); W2f is split by rows between
//     shared memory and the read-only path, as in the forward; the slot's
//     xj (then dxjc), the link's dq
//     and the warp's datt sit in the warp's slice of shared memory. The
//     per-class grads of g, b, the layer-1 rows and cbias are summed per
//     block with shared-memory atomics and flushed once per block with one
//     global f32 atomicAdd per element and block (the TPU carries them in
//     scratch through its sequential grid; blocks here run in parallel).
//     dh = dxjc W2f_k^T reads W2f rows whole (coalesced): each lane sums
//     its columns' share of 16 rows, and a transpose-reduce of 16 shuffles
//     leaves each row's sum with the lane that owns that unit; warps draw
//     links from a work counter, as in the forward;
//   * dw2 kernel: dw2 is K*dh*O f32 sums (192 KB at 128), too big for
//     shared memory beside the rest, so a second launch reduces it by
//     class and 128 x 128 tile of (dh, O): block (chunk, (k, tile)) walks
//     its links' valid slots of class k over the columns class k may hold
//     (all of them for the combined table, only its block for the classic
//     one), eight at a time, one a warp; each warp recomputes its slot's
//     hk_a + hk_b from (ps, pt) (a LayerNorm over dh, no W2f product) and
//     reads its dxjc back from dkeys (dkeys is dxj in the keys' type,
//     which is W2f's type: the same rounding); then every thread adds the
//     eight outer-product terms of its column and 64 units in registers,
//     so one LayerNorm serves the whole tile; blocks flush with one global
//     atomicAdd per element.
// Every sum across warps and blocks goes through f32 atomics, so the order
// of the additions changes from run to run.
#pragma once

#include "pe_attention_common.cuh"

namespace {

constexpr int kBwdWarps = 16;           // links in flight per block (at most)
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdBlocks = 1;           // resident blocks per SM
constexpr int kDw2Warps = 8;            // dw2 kernel
constexpr int kDw2Threads = kDw2Warps * 32;
constexpr int kDw2Tile = 128;           // units and columns per dw2 block

// floats of a main-kernel warp's slice of shared memory: hs [dh], the
// LayerNorm's units past the registers (two of smem_units(dh)), xs, dqs,
// dts [O], each 16-byte aligned
__host__ __device__ constexpr size_t bwd_slice(int dh, int O) {
  return (size_t)pad4(dh) + 2 * (size_t)smem_units(dh) + 3 * (size_t)pad4(O);
}

template <typename T, typename Cls>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
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
    float* __restrict__ dcb, float* __restrict__ datt,
    int B, int C, int O, int dh, int K, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the K classes' leading `staged` W2f rows [K, staged, O], then the
  // block's sums and the warps' slices
  T* w2s = reinterpret_cast<T*>(smem_raw);
  float* smem = reinterpret_cast<float*>(
      smem_raw + staged_bytes(K, staged, O, sizeof(T)));
  float* acc_w1 = smem;                                     // [3K, dh]
  float* acc_g = acc_w1 + 3 * K * dh;                       // [K, dh]
  float* acc_b = acc_g + K * dh;                            // [K, dh]
  float* acc_cb = acc_b + K * dh;                           // [K, O]
  float* acc_att = acc_cb + K * O;                          // [O]
  const int n_acc = 5 * K * dh + K * O + O;
  float* slices = smem + pad4(n_acc);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's slice: hs [dh] (h_a + h_b, read by every lane; then the
  // slot's dh, own units), the LayerNorm's units past the registers (own
  // units), xs [O] (the slot's xj, then dxjc), dqs [O] (the link's dq), dts
  // [O] (the warp's datt); own columns
  float* hs = slices + (size_t)warp * bwd_slice(dh, O);
  LnPair ln;
  ln.sa = hs + pad4(dh);
  ln.sb = ln.sa + smem_units(dh);
  float* xs = ln.sb + smem_units(dh);
  float* dqs = xs + pad4(O);
  float* dts = dqs + pad4(O);
  const bool vec = (O & 3) == 0;
  const float zero4[4] = {0.f, 0.f, 0.f, 0.f};

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_w1[i] = 0.f;
  for (int o = lane; o < O; o += 32) dts[o] = 0.f;
  stage_rows(w2f, w2s, K, dh, staged, O);
  __syncthreads();

  for (int b = next_link(lane, B); b < B; b = next_link(lane, B)) {
    for (int o = 4 * lane; o < O; o += kGroup)
      sts4(dqs + o, min(4, O - o), vec, zero4);
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
        T* row = dkeys + ((size_t)b * C + c0 + bit) * O;
        for (int o = 4 * lane; o < O; o += kGroup)
          storen(row + o, min(4, O - o), vec, zero4);
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
        const SplitRows<T> wk = {w2s + (size_t)k * staged * O,
                                 w2f + (size_t)k * dh * O, staged};

        // forward recompute: LayerNorm of both directions, h rounded to
        // W2f's type, one product with (h_a + h_b)
        ln.compute(w1, b1, k, dh, lane, a0, a1);
        __syncwarp();  // the previous slot's reads of hs are done
        ln.each(dh, lane, [&](int d, float& xa, float& xb) {
          const float gg = g[k * dh + d], bn = bln[k * dh + d];
          hs[d] = round_to(fmaxf(xa * gg + bn, 0.f), T()) +
                  round_to(fmaxf(xb * gg + bn, 0.f), T());
        });
        __syncwarp();

        float part = 0.f, gpart = 0.f;
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          w2_product(wk, hs, dh, O, o, n, vec, x);
          float kv[4], cb[4], qv[4], av[4], gv[4];
          loadn(keys + bc * O + o, n, vec, kv);
          loadn(cbias + (size_t)k * O + o, n, vec, cb);
          loadn(q + (size_t)b * O + o, n, vec, qv);
          loadn(att + o, n, vec, av);
          loadn(g_out + (size_t)b * O + o, n, vec, gv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] += kv[i] + cb[i];
            const float pre = x[i] * qv[i];
            part += av[i] * (pre >= 0.f ? pre : 0.2f * pre);
            gpart += gv[i] * x[i];      // 0 past the row's end
          }
          sts4(xs + o, n, vec, x);
        }
        const float s = warp_sum(part);
        const float galpha = warp_sum(gpart);
        const float alpha = expf(s - m) / lc;
        const float dlog = alpha * (galpha - dl);

        // attention backward: dxj, dq, datt, dcb, dkeys; xs becomes dxjc
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float qv[4], av[4], gv[4], x[4], dt[4], dqv[4], dxj[4], dxc[4];
          loadn(q + (size_t)b * O + o, n, vec, qv);
          loadn(att + o, n, vec, av);
          loadn(g_out + (size_t)b * O + o, n, vec, gv);
          lds4(xs + o, n, vec, x);
          lds4(dts + o, n, vec, dt);
          lds4(dqs + o, n, vec, dqv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pre = x[i] * qv[i];
            const float dpre = dlog * av[i] * (pre >= 0.f ? 1.f : 0.2f);
            dxj[i] = alpha * gv[i] + dpre * qv[i];
            dt[i] += dlog * (pre >= 0.f ? pre : 0.2f * pre);
            dqv[i] += dpre * x[i];
            dxc[i] = round_to(dxj[i], T());
            if (i < n) atomicAdd(acc_cb + k * O + o + i, dxj[i]);
          }
          sts4(dts + o, n, vec, dt);
          sts4(dqs + o, n, vec, dqv);
          sts4(xs + o, n, vec, dxc);
          storen(dkeys + bc * O + o, n, vec, dxj);
        }
        __syncwarp();  // every lane's reads of hs (the h product) are done

        // dh = dxjc W2f_k^T (the same for both directions): per 16 rows,
        // each lane's share over its columns, then a transpose-reduce whose
        // row d0 + (lane & 15) goes to the lane that owns that unit
        for (int d0 = 0; d0 < dh; d0 += 16) {
          float p[16];
#pragma unroll
          for (int r = 0; r < 16; ++r) p[r] = 0.f;
          const bool shared_rows = d0 + 16 <= wk.staged;
          for (int o = 4 * lane; o < O; o += kGroup) {
            const int n = min(4, O - o);
            float dx[4];
            lds4(xs + o, n, vec, dx);
            if (shared_rows && vec && n == 4) {
#pragma unroll
              for (int r = 0; r < 16; ++r) {
                float w[4];
                load4_shared(wk.shared + (size_t)(d0 + r) * O + o, w);
                p[r] += w[0] * dx[0] + w[1] * dx[1] + w[2] * dx[2] +
                        w[3] * dx[3];
              }
            } else {
#pragma unroll
              for (int r = 0; r < 16; ++r) {
                if (d0 + r < dh) {
                  float w[4];
                  row4(wk, d0 + r, O, o, n, vec, w);
                  p[r] += w[0] * dx[0] + w[1] * dx[1] + w[2] * dx[2] +
                          w[3] * dx[3];
                }
              }
            }
          }
          const float dhh = transpose_reduce16(p, lane);
          const int d = d0 + (lane & 15);
          if ((lane & 16) == (d0 & 16) && d < dh) hs[d] = dhh;
        }

        // the ReLU and LayerNorm backward of each direction
        float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
        ln.each(dh, lane, [&](int d, float& xa, float& xb) {
          const float dhh = hs[d];
          const float gg = g[k * dh + d], bn = bln[k * dh + d];
          const float dya = xa * gg + bn > 0.f ? dhh : 0.f;
          const float dyb = xb * gg + bn > 0.f ? dhh : 0.f;
          atomicAdd(acc_g + k * dh + d, dya * xa + dyb * xb);
          atomicAdd(acc_b + k * dh + d, dya + dyb);
          s1a += dya * gg;
          s2a += dya * gg * xa;
          s1b += dyb * gg;
          s2b += dyb * gg * xb;
        });
        const float m1a = warp_sum(s1a) / dh, m2a = warp_sum(s2a) / dh;
        const float m1b = warp_sum(s1b) / dh, m2b = warp_sum(s2b) / dh;
        ln.each(dh, lane, [&](int d, float& xa, float& xb) {
          const float dhh = hs[d];
          const float gg = g[k * dh + d], bn = bln[k * dh + d];
          const float dxa = (xa * gg + bn > 0.f ? dhh : 0.f) * gg;
          const float dxb = (xb * gg + bn > 0.f ? dhh : 0.f) * gg;
          const float dpa = ln.inv_a * (dxa - m1a - xa * m2a);
          const float dpb = ln.inv_b * (dxb - m1b - xb * m2b);
          // layer-1 input rows: direction a sees (ps, pt, 1), b (pt, ps, 1)
          atomicAdd(acc_w1 + k * dh + d, a0 * dpa + a1 * dpb);
          atomicAdd(acc_w1 + (K + k) * dh + d, a1 * dpa + a0 * dpb);
          atomicAdd(acc_w1 + (2 * K + k) * dh + d, dpa + dpb);
        });
      }
    }
    for (int o = 4 * lane; o < O; o += kGroup) {
      const int n = min(4, O - o);
      float r[4];
      lds4(dqs + o, n, vec, r);
      storen(dq + (size_t)b * O + o, n, vec, r);
    }
  }

  __syncwarp();  // dts holds every lane's columns
  for (int o = lane; o < O; o += 32) atomicAdd(acc_att + o, dts[o]);
  __syncthreads();
  // one global atomic per element and block
  for (int i = threadIdx.x; i < 3 * K * dh; i += blockDim.x)
    atomicAdd(dw1cat + i, acc_w1[i]);
  for (int i = threadIdx.x; i < K * dh; i += blockDim.x) {
    atomicAdd(dg + i, acc_g[i]);
    atomicAdd(db + i, acc_b[i]);
  }
  for (int i = threadIdx.x; i < K * O; i += blockDim.x)
    atomicAdd(dcb + i, acc_cb[i]);
  for (int i = threadIdx.x; i < O; i += blockDim.x)
    atomicAdd(datt + i, acc_att[i]);
}

// One warp's walk over the valid slots of class k in its links (links b0,
// b0 + stride, ...; columns [c_lo, c_hi)): next() moves to the next such
// slot and returns false when there is none.
template <typename Cls>
struct SlotWalk {
  const uint8_t* valid;
  const float* ps;
  const float* pt;
  Cls cls;
  int B, C, k, c_lo, c_hi, stride, lane;
  int b, c0;                 // the current link and 32-column chunk
  unsigned live = 0;         // its valid slots of class k not yet taken
  float ps_l = 0.f, pt_l = 0.f;
  size_t bc = 0;             // the slot taken, and its ps and pt
  float a0 = 0.f, a1 = 0.f;

  __device__ __forceinline__ bool next() {
    while (!live) {
      c0 += 32;
      if (c0 >= c_hi) {
        b += stride;
        c0 = c_lo;
      }
      if (b >= B) return false;
      const int cl = c0 + lane;
      const size_t bcl = (size_t)b * C + cl;
      const bool v = cl < c_hi && valid[bcl] && cls.holds(bcl, cl, k);
      live = __ballot_sync(kFull, v);
      ps_l = v ? ps[bcl] : 0.f;
      pt_l = v ? pt[bcl] : 0.f;
    }
    const int bit = __ffs(live) - 1;
    live &= live - 1;
    a0 = __shfl_sync(kFull, ps_l, bit);
    a1 = __shfl_sync(kFull, pt_l, bit);
    bc = (size_t)b * C + c0 + bit;
    return true;
  }
};

// dw2[k][d0 .. d0+127][o0 .. o0+127] = sum over valid slots of class k of
// (hk_a + hk_b)^T dxjc, for block (chunk, (k * ndc + dc) * noc + oc):
// hidden units d0 = dc * 128 onwards, columns o0 = oc * 128 onwards. In
// each round every warp takes the next valid slot of its links, recomputes
// its h over the block's units (a LayerNorm over all dh) and reads its
// dxjc over the block's columns from dkeys, both into shared memory; then
// every thread adds the round's eight outer-product terms of its column
// and its 64 units, so one LayerNorm serves a 128 x 128 tile.
template <typename T, typename Cls>
__global__ void __launch_bounds__(kDw2Threads, 2)
pe_attention_dw2_kernel(
    const T* __restrict__ dkeys, const float* __restrict__ ps,
    const float* __restrict__ pt, const uint8_t* __restrict__ valid,
    const Cls cls, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ g,
    const float* __restrict__ bln, float* __restrict__ dw2, int B, int C,
    int O, int dh, int ndc, int noc) {
  extern __shared__ __align__(16) float smem[];
  float (*hb)[kDw2Tile] = reinterpret_cast<float (*)[kDw2Tile]>(smem);
  float (*db)[kDw2Tile] = hb + kDw2Warps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's LayerNorm units past the registers
  LnPair ln;
  ln.sa = smem + 2 * kDw2Warps * kDw2Tile + (size_t)warp * 2 * smem_units(dh);
  ln.sb = ln.sa + smem_units(dh);
  const int k = blockIdx.y / (ndc * noc), tile = blockIdx.y % (ndc * noc);
  const int d0 = (tile / noc) * kDw2Tile, nd = min(kDw2Tile, dh - d0);
  const int o0 = (tile % noc) * kDw2Tile, no = min(kDw2Tile, O - o0);
  // this thread's column of the tile and its half of the tile's units
  const int col = threadIdx.x & (kDw2Tile - 1);
  const int half = threadIdx.x / kDw2Tile;
  const int c_lo = cls.begin(k), c_hi = cls.end(k, C);
  SlotWalk<Cls> walk{valid, ps, pt, cls, B, C, k, c_lo, c_hi,
                     (int)gridDim.x * kDw2Warps, lane,
                     (int)blockIdx.x * kDw2Warps + warp, c_lo - 32};

  float acc[kDw2Tile / 2];
#pragma unroll
  for (int i = 0; i < kDw2Tile / 2; ++i) acc[i] = 0.f;
  bool more = true;

  while (__syncthreads_or(more)) {
    if (more) more = walk.next();
    if (more) {
      ln.compute(w1, b1, k, dh, lane, walk.a0, walk.a1);
      ln.each(dh, lane, [&](int u, float& xa, float& xb) {
        if (u >= d0 && u < d0 + nd) {
          const float gg = g[k * dh + u], bn = bln[k * dh + u];
          hb[warp][u - d0] = round_to(fmaxf(xa * gg + bn, 0.f), T()) +
                             round_to(fmaxf(xb * gg + bn, 0.f), T());
        }
      });
      for (int d = nd + lane; d < kDw2Tile; d += 32) hb[warp][d] = 0.f;
      const T* row = dkeys + walk.bc * O + o0;
      for (int o = lane; o < kDw2Tile; o += 32)
        db[warp][o] = o < no ? to_f32(row[o]) : 0.f;
    } else {        // no slot left: a zero term (no stale values)
      for (int o = lane; o < kDw2Tile; o += 32)
        hb[warp][o] = db[warp][o] = 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int w = 0; w < kDw2Warps; ++w) {
      const float dk = db[w][col];
      const float* h = hb[w] + half * (kDw2Tile / 2);
#pragma unroll
      for (int i = 0; i < kDw2Tile / 2; i += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(h + i);
        acc[i] += h4.x * dk;
        acc[i + 1] += h4.y * dk;
        acc[i + 2] += h4.z * dk;
        acc[i + 3] += h4.w * dk;
      }
    }
  }

  if (col < no) {
#pragma unroll
    for (int i = 0; i < kDw2Tile / 2; ++i) {
      const int d = half * (kDw2Tile / 2) + i;
      if (d < nd)
        atomicAdd(dw2 + ((size_t)k * dh + d0 + d) * O + o0 + col, acc[i]);
    }
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
  if (O < 1 || dh < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t fixed =
      sizeof(float) * pad4(5 * K * dh + K * O + O);
  const size_t per_warp = sizeof(float) * bwd_slice(dh, O);
  const size_t cap = block_smem_cap(kBwdBlocks);
  const int warps = warps_that_fit(kBwdWarps, fixed, per_warp, cap);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int staged =
      rows_that_fit(K, dh, O, sizeof(T), fixed + warps * per_warp, cap);
  const size_t smem =
      staged_bytes(K, staged, O, sizeof(T)) + fixed + warps * per_warp;
  auto kern = pe_attention_bwd_kernel<T, Cls>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, warps * 32, smem, kBwdBlocks,
                                    (B + warps - 1) / warps, &grid, &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)keys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)q, (const float*)g_out,
      (const float*)m, (const float*)l, (const float*)delta,
      (const float*)w1, (const float*)b1, (const float*)g,
      (const float*)bln, (const T*)w2f, (const float*)cbias,
      (const float*)att, (T*)dkeys, (float*)dq, (float*)dw1cat, (float*)dg,
      (float*)db, (float*)dcb, (float*)datt, B, C, O, dh, K,
      staged);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dw2: about two waves of blocks over (link chunk, class, dh tile,
  // column tile)
  const int ndc = (dh + kDw2Tile - 1) / kDw2Tile;
  const int noc = (O + kDw2Tile - 1) / kDw2Tile;
  const int ky = K * ndc * noc;
  int nchunk = (2 * sms + ky - 1) / ky;
  const int max_chunk = (B + kDw2Warps - 1) / kDw2Warps;
  if (nchunk > max_chunk) nchunk = max_chunk;
  if (nchunk < 1) nchunk = 1;
  const size_t smem2 =
      sizeof(float) * (2 * (size_t)kDw2Warps * kDw2Tile +
                       (size_t)kDw2Warps * 2 * smem_units(dh));
  auto kern2 = pe_attention_dw2_kernel<T, Cls>;
  if ((err = cudaFuncSetAttribute(
           kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2)) !=
      cudaSuccess)
    return (int)err;
  kern2<<<dim3(nchunk, ky), kDw2Threads, smem2, stream>>>(
      (const T*)dkeys, (const float*)ps, (const float*)pt,
      (const uint8_t*)valid, cls, (const float*)w1, (const float*)b1,
      (const float*)g, (const float*)bln, (float*)dw2, B, C, O, dh, ndc,
      noc);
  return (int)cudaGetLastError();
}

}  // namespace
