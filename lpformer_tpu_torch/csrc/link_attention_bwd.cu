// Fused per-link GATv2 attention without PE, backward pass, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/attention.py:
// _bwd_kernel (:137) behind _bwd_call (:225, pallas_call :230), reached
// from the custom VJP _fused_bwd (:302), heads == 1.
//
// Recomputes each valid slot's xj = keys @ W_r + r_bias and logit s with
// the forward's prologue (csrc/link_attention_tiles.cuh: the same bits),
// then, from the forward's m, l, with g_out [B, O] and delta[b] = g_out[b]
// . (out[b] - bias):
//   alpha  = exp(s - m) / max(l, 1e-16)         (0 on dead slots)
//   dlogit = alpha * (g_out . xj - delta)
//   dxj    = alpha g_out + dlogit att lrelu'(xj q) q
//   dq     = sum_c dlogit att lrelu'(xj q) xj;  datt = sum dlogit lrelu(xj q)
//   dr_bias = sum dxj;  dxjc = dxj rounded to the keys' type
//   dkeys  = dxjc W_r^T in the keys' type (0 on dead slots)
//   dW     = sum over valid slots of keys^T dxjc              (f32)
// as the TPU kernel rounds: dxjc before both products (:203-210).
//
// What bounds it on an H100: at the bench's A/B shape the bytes of dkeys
// (every slot's row, 268 MB in bf16) and of the valid key rows (215 MB),
// 146 us at 3.35 TB/s, against three Dk x O products a valid slot (84 us
// on the bf16 tensor cores; in f32 1.2 ms on the CUDA cores). Design, in
// two launches:
//   * main kernel: a persistent block takes whole links. Per link it
//     lists the valid columns (and keeps the validity bits), writes the
//     dead slots' dkeys rows as zeros itself, a warp a row (so dkeys is
//     written once, with no memset), then per chunk of up to 128 valid
//     rows runs the shared prologue, takes each row's alpha and dlogit,
//     and two threads per column (each half of the rows) walk the rows:
//     dxj, its dxjc into shared memory (bf16 over the spent key rows, f32
//     over xj) and into the [B, C, O] scratch by slot, and the column's
//     dq, datt and dr_bias sums, the halves then added in order. dkeys =
//     dxjc W_r^T (mma.sync in bf16, staged in shared memory so each row is
//     written whole; in f32 FMA micro-tiles of 8 rows x 4 columns, W_r in
//     two buffers of 64 rows over the stream stages) goes to the slots'
//     rows. dq is written once per link; datt and dr_bias are block sums,
//     one f32 atomic per element and block;
//   * dW kernel: dW [Dk, O] sums over every valid slot of the batch while
//     blocks run in parallel (the TPU carries it in scratch through its
//     sequential grid), so a split-K product: block (link chunk, 128 x 128
//     tile of (Dk, O)) lists its links' valid slots into a queue and takes
//     them 64 at a time, keys and dxjc (read back from the scratch) by
//     cp.async, keys^T dxjc on mma.sync (transposed operand loads) or as
//     8 x 8 f32 FMA micro-tiles a thread; one f32 atomic per element and
//     block.
// The sums across blocks (dW, datt, dr_bias) go through f32 atomics, so the
// order of their additions changes from run to run; dkeys and dq do not.

#include "link_attention_tiles.cuh"

namespace {

constexpr int kDwT = 128;               // rows and columns of a dW tile
constexpr int kDwThreads = 256;         // of a dW block: 8 warps
constexpr int kDwSlots = 64;            // slots a dW block takes at a time

// two consecutive bf16 elements (4-byte aligned p)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dkeys of the chunk's rows r < n, columns d0 .. d0 + nr: dxjc D [ts, ks]
// (zeros past O up to op) times the staged W_r rows (Wc [nr, ws])
// transposed, rounded to T, into row row0 + list[r] of dkeys [*, Dk].
// bf16: a warp per 16 x 64 tile on mma.sync, W_r's rows as the B operand
// by columns (bt_rows), the tile staged in shared memory for whole-row
// writes where it fits. f32: a thread per 8 rows x 4 columns
// (d, d + nr/4, ...; a quarter warp reads 8 W rows at one column, on
// distinct banks), 4 depth steps per round: 12 float4 reads feed 128
// FMAs.
template <typename T>
__device__ void product_dk(const T* D, int ks, const T* W, int ws, int op,
                           int d0, int nr, int n, int ts, const int* list,
                           size_t row0, int Dk, T* __restrict__ dkeys,
                           float* X, int xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int nq = nr / 4, items = (ts / 8) * nq;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int r0 = (it / nq) * 8, dg = it % nq;
      if (r0 >= n) continue;
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int o = 0; o < op; o += 4) {
        float dv[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              D + (size_t)(r0 + i) * ks + o);
          dv[i][0] = v.x; dv[i][1] = v.y; dv[i][2] = v.z; dv[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              W + (size_t)(dg + j * nq) * ws + o);
          const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[i][j] = __fmaf_rn(dv[i][u], wv[u], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i;
        if (r >= n) continue;
        T* dst = dkeys + (row0 + list[r]) * Dk + d0 + dg;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + dg + j * nq < Dk) dst[j * nq] = acc[i][j];
      }
    }
  } else {
    // bf16: the tile goes through E (over X, whose xj is spent) where E's
    // rows fit, so each dkeys row is written whole
    const int es = nr + 8;
    const bool staged = es * 2 <= xs * 4;
    T* E = reinterpret_cast<T*>(X);
    const int nmt = ts / 16, items = nmt * ((nr + 63) / 64);
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    for (int it = warp; it < items; it += kWarps) {
      const int m0 = (it % nmt) * 16, n0 = (it / nmt) * 64;
      if (m0 >= n) continue;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < op; kk += 16) {
        uint32_t fa[4], b[4][4];
        ldsm_x4(fa, a_rows(D, ks, m0, kk, lane));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + 16 * j < nr)
            ldsm_x4(b[j], bt_rows(W, ws, n0 + 16 * j, kk, lane));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n0 + 16 * j < nr) {
            mma_bf16(acc[2 * j], fa, b[j][0], b[j][1]);
            mma_bf16(acc[2 * j + 1], fa, b[j][2], b[j][3]);
          }
        }
      }
      if (staged) {       // into E, rows written out below
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* er = E + (size_t)(m0 + g + 8 * h) * es;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (n0 + 8 * j < nr)
              store2(er + n0 + 8 * j + t2, acc[j][2 * h], acc[j][2 * h + 1]);
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        if (r >= n) continue;
        T* dst = dkeys + (row0 + list[r]) * Dk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d0 + n0 + 8 * j + t2;
          if (n0 + 8 * j >= nr || d >= Dk) continue;
          if ((Dk & 1) == 0) {
            store2(dst + d, acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            from_f32(acc[j][2 * h], dst + d);
            if (d + 1 < Dk) from_f32(acc[j][2 * h + 1], dst + d + 1);
          }
        }
      }
    }
    if (!staged) return;
    // E's rows to the slots' dkeys rows, 16 bytes a lane where they allow
    __syncthreads();
    const int nc = min(nr, Dk - d0);
    const bool vec = Dk % 8 == 0;
    for (int r = warp; r < n; r += kWarps) {
      T* dst = dkeys + (row0 + list[r]) * Dk + d0;
      const T* er = E + (size_t)r * es;
      for (int c = lane * 8; c < nc; c += 256) {
        if (vec) {
          *reinterpret_cast<uint4*>(dst + c) =
              *reinterpret_cast<const uint4*>(er + c);
        } else {
          for (int e = 0; e < 8 && c + e < nc; ++e) dst[c + e] = er[c + e];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
link_attention_bwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, const float* __restrict__ g_out,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, const T* __restrict__ w,
    const float* __restrict__ rbias, const float* __restrict__ att,
    T* __restrict__ dkeys, T* __restrict__ dxc, float* __restrict__ dq,
    float* __restrict__ drb, float* __restrict__ datt, int B, int C,
    int Dk, int O, int ts, int dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LinkSmem L{Dk, O, C, ts, dc, (int)sizeof(T)};
  const LinkPtrs<T> p(smem_raw, L);
  const int ks = L.ks(), ws = L.ws(), xs = L.xs();
  const int dkp = pad16(Dk), op = pad16(O);
  float* dqs = p.vec;                   // [O] the link's dq
  float* dts = p.vec + op;              // [O] the block's datt
  float* drs = p.vec + 2 * op;          // [O] the block's dr_bias
  float* part = p.vec + 3 * op;         // [kParts][3][O] the walk's parts
  float* alpha = p.rows + kS * ts;      // the logits, then alpha
  float* dlog = p.rows + kG * ts;       // g_out . xj, then dlogit
  // dxjc [ts, ds]: over the key rows (bf16), over xj element by element
  // (f32: each element is read, then written, by the same thread)
  constexpr bool f32 = std::is_same<T, float>::value;
  T* dx = f32 ? reinterpret_cast<T*>(p.x) : p.kt;
  const int ds = f32 ? xs : ks;

  for (int o = threadIdx.x; o < O; o += blockDim.x) dts[o] = drs[o] = 0.f;
  if (L.resident()) stage_w(w, p.wsm, 0, dkp, Dk, O, ws);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t row0 = (size_t)b * C;
    const int nv = list_valid(valid + row0, C, 0, p.list, p.mask, p.wcnt);
    // the dead slots' dkeys rows: zeros, a warp a row
    {
      constexpr int vw = 16 / sizeof(T);
      const bool vec = Dk % vw == 0;
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int c = warp; c < C; c += kWarps) {
        if ((p.mask[c >> 5] >> (c & 31)) & 1u) continue;
        T* row = dkeys + (row0 + c) * Dk;
        if (vec) {
          for (int d = lane * vw; d < Dk; d += 32 * vw)
            *reinterpret_cast<uint4*>(row + d) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          for (int d = lane; d < Dk; d += 32) from_f32(0.f, row + d);
        }
      }
    }
    for (int o = threadIdx.x; o < O; o += blockDim.x) dqs[o] = 0.f;
    const float m = m_in[b], l = l_in[b], dl = delta_in[b];

    for (int r0 = 0; r0 < nv; r0 += ts) {
      const int n = min(ts, nv - r0);
      const int* list = p.list + r0;
      chunk_xj<T, true>(keys, q, g_out, w, rbias, att, L, p, list, n, b);
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        const float a = softmax_weight(alpha[r], m, l);
        alpha[r] = a;
        dlog[r] = a * (dlog[r] - dl);
      }
      __syncthreads();
      // each part of the rows walks every column: dxj, dxjc, and its
      // share of dq, datt and dr_bias, then the parts are added in order
      const int parts = walk_parts(O);
      for (int t = threadIdx.x; t < parts * O; t += blockDim.x) {
        const int col = t % O, pt = t / O;
        int ra, rb;
        row_split(n, parts, pt, ra, rb);
        const float av = att[col], qv = q[(size_t)b * O + col];
        const float gv = g_out[(size_t)b * O + col];
        float sq = 0.f, st = 0.f, sr = 0.f;
#pragma unroll 4
        for (int r = ra; r < rb; ++r) {
          const float x = p.x[(size_t)r * xs + col];
          const float a = alpha[r], dlg = dlog[r];
          const float pre = x * qv;
          const float dpre = dlg * av * (pre >= 0.f ? 1.f : 0.2f);
          const float dxj = a * gv + dpre * qv;
          st += dlg * (pre >= 0.f ? pre : 0.2f * pre);
          sq += dpre * x;
          sr += dxj;
          T v;
          from_f32(dxj, &v);
          dx[(size_t)r * ds + col] = v;
          dxc[(row0 + list[r]) * O + col] = v;
        }
        float* ps = part + (size_t)pt * 3 * op;
        ps[col] = sq;
        ps[op + col] = st;
        ps[2 * op + col] = sr;
      }
      // the product's padding: rows past n, columns past O
      for (int i = threadIdx.x; i < ts * op; i += blockDim.x) {
        const int r = i / op, c = i % op;
        if (r >= n || c >= O) from_f32(0.f, dx + (size_t)r * ds + c);
      }
      __syncthreads();
      for (int o = threadIdx.x; o < O; o += blockDim.x) {
        float sq = part[o], st = part[op + o], sr = part[2 * op + o];
        for (int k = 1; k < parts; ++k) {
          const float* ps = part + (size_t)k * 3 * op;
          sq += ps[o];
          st += ps[op + o];
          sr += ps[2 * op + o];
        }
        dqs[o] += sq;
        dts[o] += st;
        drs[o] += sr;
      }
      // dkeys = dxjc W_r^T
      over_w_chunks(w, L, p, [&](const T* wc, int d0, int nr) {
        product_dk<T>(dx, ds, wc, ws, op, d0, nr, n, ts, list, row0, Dk,
                      dkeys, p.x, xs);
      });
    }
    __syncthreads();
    for (int o = threadIdx.x; o < O; o += blockDim.x)
      dq[(size_t)b * O + o] = dqs[o];
  }

  __syncthreads();
  if ((int)blockIdx.x >= B) return;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    atomicAdd(drb + o, drs[o]);
    atomicAdd(datt + o, dts[o]);
  }
}

// dW[d0 .. d0+127][o0 .. o0+127] = sum over the valid slots of links
// [b_lo, b_hi) of keys[d]^T dxjc[o], for block (chunk, dc * noc + oc):
// d0 = dc * 128, o0 = oc * 128. The block appends each link's valid slots
// to a queue in shared memory and takes them 64 at a time: their key rows
// over the tile's rows and their dxjc over its columns, by cp.async; bf16:
// warp w the tile's rows (w % 4) * 32 .. +32 and columns (w / 4) * 64 ..
// +64 on mma.sync, the keys as the A operand by columns (at_rows); f32: a
// thread per 8 rows (4 at tr * 4, 4 at tr * 4 + 64) x 8 columns (likewise
// from tc * 4): 4 float4 reads a slot feed 64 FMAs.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
link_attention_dw_kernel(const T* __restrict__ keys,
                         const T* __restrict__ dxc,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ dw, int B, int C, int Dk, int O,
                         int noc, int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int st = tile_stride(kDwT, sizeof(T));
  T* kt = reinterpret_cast<T*>(smem_raw);   // [kDwSlots, st] slots x rows
  T* dt = kt + kDwSlots * st;               // [kDwSlots, st] slots x columns
  int* queue = reinterpret_cast<int*>(dt + kDwSlots * st);  // [.. + C]
  int* wcnt = queue + kDwSlots + C;                         // [kMaxWarps]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = (blockIdx.y / noc) * kDwT, nd = min(kDwT, Dk - d0);
  const int o0 = (blockIdx.y % noc) * kDwT, no = min(kDwT, O - o0);
  const int b_lo = blockIdx.x * per_block, b_hi = min(B, b_lo + per_block);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int qn = 0;
  for (int b = b_lo; b < b_hi || qn > 0;) {
    if (b < b_hi && qn < kDwSlots) {
      qn += list_valid(valid + (size_t)b * C, C, b * C, queue + qn, nullptr,
                       wcnt);
      ++b;
      continue;
    }
    const int n = min(kDwSlots, qn);
    gather_tile(kt, st, keys, Dk, d0, kDwT, kDwSlots, n,
                [&](int r) { return (size_t)queue[r]; });
    gather_tile(dt, st, dxc, O, o0, kDwT, kDwSlots, n,
                [&](int r) { return (size_t)queue[r]; });
    cp_async_wait_all();
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
      const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
      for (int s = 0; s < n; ++s) {
        const float* kr = kt + s * st + tr * 4;
        const float* dr = dt + s * st + tc * 4;
        const float4 k0 = *reinterpret_cast<const float4*>(kr);
        const float4 k1 = *reinterpret_cast<const float4*>(kr + 64);
        const float4 v0 = *reinterpret_cast<const float4*>(dr);
        const float4 v1 = *reinterpret_cast<const float4*>(dr + 64);
        const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float dv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i * 8 + j] = __fmaf_rn(kv[i], dv[j], acc[i * 8 + j]);
      }
    } else {
      const int mb = (warp & 3) * 32, nb = (warp >> 2) * 64;
      for (int kk = 0; kk < n; kk += 16) {
        uint32_t bf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldsm_x4_t(bf[j], b_rows(dt, st, nb + 16 * j, kk, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4_t(a, at_rows(kt, st, mb + 16 * mi, kk, lane));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_bf16(acc + (mi * 8 + 2 * j) * 4, a, bf[j][0], bf[j][1]);
            mma_bf16(acc + (mi * 8 + 2 * j + 1) * 4, a, bf[j][2], bf[j][3]);
          }
        }
      }
    }
    // the queue's rest to its front (read all, then write)
    __syncthreads();
    const int rest = qn - n;
    for (int base = 0; base < rest; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int v = i < rest ? queue[n + i] : 0;
      __syncthreads();
      if (i < rest) queue[i] = v;
      __syncthreads();
    }
    qn = rest;
  }

  if constexpr (std::is_same<T, float>::value) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = tr * 4 + (i & 3) + (i >> 2) * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc * 4 + (j & 3) + (j >> 2) * 64;
        if (d < nd && c < no)
          atomicAdd(dw + (size_t)(d0 + d) * O + o0 + c, acc[i * 8 + j]);
      }
    }
  } else {
    const int mb = (warp & 3) * 32, nb = (warp >> 2) * 64;
    const int gi = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = mb + 16 * mi + gi + 8 * (i >> 1);
          const int c = nb + 8 * j + t2 + (i & 1);
          if (d < nd && c < no)
            atomicAdd(dw + (size_t)(d0 + d) * O + o0 + c,
                      acc[(mi * 8 + j) * 4 + i]);
        }
  }
}

template <typename T>
int launch(const void* keys, const void* q, const void* valid,
           const void* g_out, const void* m, const void* l,
           const void* delta, const void* w, const void* rbias,
           const void* att, void* dkeys, void* dxc, void* dq, void* dw,
           void* drb, void* datt, int B, int C, int Dk, int O,
           cudaStream_t stream) {
  if (B == 0) return 0;
  auto kern = link_attention_bwd_kernel<T>;
  LinkLaunch t;
  cudaError_t err = link_launch(kern, B, C, Dk, O, (int)sizeof(T), &t);
  if (err != cudaSuccess) return (int)err;
  kern<<<t.grid, kThreads, t.smem, stream>>>(
      (const T*)keys, (const float*)q, (const uint8_t*)valid,
      (const float*)g_out, (const float*)m, (const float*)l,
      (const float*)delta, (const T*)w, (const float*)rbias,
      (const float*)att, (T*)dkeys, (T*)dxc, (float*)dq, (float*)drb,
      (float*)datt, B, C, Dk, O, t.L.ts, t.L.dc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dW: about two waves of blocks over (link chunk, row tile, column tile)
  const int ndc = (Dk + kDwT - 1) / kDwT, noc = (O + kDwT - 1) / kDwT;
  const int ky = ndc * noc;
  int nchunk = (2 * t.sms + ky - 1) / ky;
  if (nchunk > B) nchunk = B;
  const int per_block = (B + nchunk - 1) / nchunk;
  nchunk = (B + per_block - 1) / per_block;
  const size_t smem2 =
      2 * (size_t)kDwSlots * tile_stride(kDwT, sizeof(T)) * sizeof(T) +
      sizeof(int) * ((size_t)kDwSlots + C + kMaxWarps);
  auto kern2 = link_attention_dw_kernel<T>;
  if ((err = cudaFuncSetAttribute(
           kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2)) !=
      cudaSuccess)
    return (int)err;
  kern2<<<dim3(nchunk, ky), kDwThreads, smem2, stream>>>(
      (const T*)keys, (const T*)dxc, (const uint8_t*)valid, (float*)dw, B, C,
      Dk, O, noc, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`; returns cudaGetLastError() after the
// launches (0 = ok). bf16 != 0: keys, w, dkeys and the dxc scratch [B, C,
// O] are bfloat16, else float32. valid is uint8/bool, everything else
// float32. dkeys and dq are written in full; dw [Dk, O], drb and datt [O]
// are summed into and must be zeroed by the caller.
int link_attention_bwd(const void* keys, const void* q, const void* valid,
                       const void* g_out, const void* m, const void* l,
                       const void* delta, const void* w, const void* rbias,
                       const void* att, void* dkeys, void* dxc, void* dq,
                       void* dw, void* drb, void* datt, int B, int C,
                       int Dk, int O, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(keys, q, valid, g_out, m, l, delta, w, rbias,
                                 att, dkeys, dxc, dq, dw, drb, datt, B, C, Dk,
                                 O, s);
  return launch<float>(keys, q, valid, g_out, m, l, delta, w, rbias, att,
                       dkeys, dxc, dq, dw, drb, datt, B, C, Dk, O, s);
}

const char* link_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
