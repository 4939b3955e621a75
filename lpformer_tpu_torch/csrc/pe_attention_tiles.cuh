// The tile machinery of the fused PE + per-link attention kernels, for
// Hopper (sm_90a): what the forward (csrc/pe_attention_fwd_tiles.cuh) and
// the backward (csrc/pe_attention_bwd_tiles.cuh) share.
//
// Both directions take the valid slots as the wrapper lists them in
// (class, link, column) order with the classes' offsets on the device
// (ops/pe_attention_mixed.py:compact_tagged_slots, from the combined
// table's class tags or the classic table's column blocks), in tiles of TS
// slots of one class: a tile's class is its place in that list. Both run
// one prologue per tile (tile_xj, then row_logit per row):
//   * every thread reads a row's slot id, key row and PPR values at once:
//     the key row is ids[slot] of the key table (a node table the wrapper
//     passes with the context ids, so that no [B, C, O] copy of its rows is
//     ever written), or the slot's own row when ids is null (a dense
//     [B, C, O] key tensor, the same read with the identity map);
//   * (a) a warp per slot recomputes both directions' LayerNorm and keeps
//     [Ha | Hb], TS x 2 dh in W2f's type, in shared memory;
//   * (b) X = [Ha | Hb] [W2f_k ; W2f_k] on the tensor cores (mma.sync
//     m16n8k16 bf16, f32 accumulate): each direction's rounded h is
//     multiplied separately, as the TPU kernel and the plain version do;
//     or for f32 inputs (Ha + Hb) W2f_k as FMA loops on the CUDA cores
//     (not TF32; h is not rounded there, so only the order of the f32
//     additions differs);
//   * (c) every thread adds the key rows (16-byte reads) and cbias: xj;
//   * a warp per slot sums its logit s = sum_o att[o] lrelu(xj[o] q[b,o])
//     lane by lane (columns lane + 32 j) and then across the warp.
// So a slot's xj and s come out bit for bit the same in both directions:
// the same instructions in the same order, the roundings pinned with
// explicit intrinsics (no contraction left to the compiler), W2f staged in
// the same row chunks (w2_rows), and alpha = exp(s - m) / max(l, 1e-16)
// one expression (softmax_weight). W2f_k sits in shared memory for the
// class's run of tiles where it fits (every width the presets use in
// bf16), else it is staged in row chunks per product.
#pragma once

#include <type_traits>

#include "pe_attention_common.cuh"

namespace {

// per-row fields of a tile, [kRowF][TS] floats
enum RowField { kA0, kA1, kMuA, kInvA, kMuB, kInvB, kAlpha, kDlog, kM1A,
                kM2A, kM1B, kM2B, kRowF };
// tile_xj fills the fields [0, kPrologueF) (PPR values, LayerNorm
// statistics); the others are the directions' own, written after it
// returns.
constexpr int kPrologueF = kInvB + 1;
// The rows' key rows share kDlog's field, as int bits: tile_xj writes them
// with the slot ids and reads them in (c), and the backward writes dlogit
// there only after the prologue's last barrier. A field of their own would
// cost TS ints of shared memory: the bf16 backward at O = dh = 128, K = 3
// takes 115,712 bytes a block, two blocks with their 1 KB reserve each
// exactly the SM's 233,472, so 256 bytes more leave one block an SM.
constexpr int kKeyRow = kDlog;
static_assert(kKeyRow >= kPrologueF && kKeyRow < kRowF,
              "the key rows' field must be one tile_xj does not fill");

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Warps of a block with tiles of TS slots: 8 for 64 (two blocks share an
// SM), 16 for 32 (one block fills an SM's shared memory at O = dh = 256,
// so it brings its own warps).
__host__ __device__ constexpr int tile_warps(int ts) { return ts == 32 ? 16 : 8; }

// Row stride in elements of a shared-memory tile with n columns of
// `elem`-byte elements: n padded to 16, plus 16 bytes, so the eight rows
// an ldmatrix reads start on distinct banks.
__host__ __device__ constexpr int tile_stride(int n, int elem) {
  return pad16(n) + 16 / elem;
}

// The backward's f32 weight-grad sums a block keeps in shared memory
// (dw1cat [3K, dh], dg, db [K, dh], dcb [K, O], datt [O]).
__host__ __device__ constexpr int bwd_sums(int K, int O, int dh) {
  return 5 * K * dh + K * O + O;
}

// A tile kernel's shared memory: W2f_k rows [dc, O]; [Ha | Hb]
// [TS, 2 pad16(dh)], which the backward's dxjc [TS, O] then reuses; X
// (then the backward's dH), f32 [TS, max(O, dh)]; the rows' slot and link
// ids and fields; n_acc f32 sums (the backward's, 0 for the forward).
struct TileSmem {
  int ts, O, dh, dc, elem, n_acc;
  __host__ __device__ int ws() const { return tile_stride(O, elem); }
  __host__ __device__ int hs() const { return tile_stride(2 * pad16(dh), elem); }
  __host__ __device__ int xs() const { return imax(pad16(O), pad16(dh)) + 4; }
  __host__ __device__ size_t w_bytes() const {
    return align16((size_t)dc * ws() * elem);
  }
  __host__ __device__ size_t hx_bytes() const {
    return align16((size_t)ts * imax(hs(), ws()) * elem);
  }
  __host__ __device__ size_t xd_bytes() const {
    return align16((size_t)ts * xs() * 4);
  }
  __host__ __device__ size_t row_bytes() const {
    return align16((size_t)ts * (2 + kRowF) * 4);
  }
  __host__ __device__ size_t fixed_bytes() const {
    return hx_bytes() + xd_bytes() + row_bytes() + align16(4 * (size_t)n_acc);
  }
  __host__ __device__ size_t total() const { return w_bytes() + fixed_bytes(); }
};

// TileSmem's arrays in a kernel's dynamic shared memory.
template <typename T>
struct TilePtrs {
  T* wsm;        // W2f_k rows [dc, ws]
  T* hx;         // [Ha | Hb] [TS, hs]
  float* xd;     // X [TS, xs]
  int* rslot;    // [TS]
  int* rlink;    // [TS]
  float* rf;     // [kRowF][TS]
  float* acc;    // [n_acc]
  __device__ TilePtrs(unsigned char* raw, const TileSmem& L) {
    wsm = reinterpret_cast<T*>(raw);
    hx = reinterpret_cast<T*>(raw + L.w_bytes());
    xd = reinterpret_cast<float*>(raw + L.w_bytes() + L.hx_bytes());
    rslot = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(xd) +
                                   L.xd_bytes());
    rlink = rslot + L.ts;
    rf = reinterpret_cast<float*>(rlink + L.ts);
    acc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(rslot) +
                                   L.row_bytes());
  }
};

// A launch's tiles: class k's slots [off[k], off[k+1]) of the compacted
// list, cut into ntile[k] tiles of TS, numbered class by class.
struct TileList {
  int off[4] = {0, 0, 0, 0}, ntile[3] = {0, 0, 0}, total = 0;
  __device__ TileList(const int32_t* __restrict__ offsets, int K, int ts) {
    for (int k = 0; k <= K; ++k) off[k] = offsets[k];
    for (int k = 0; k < K; ++k) {
      ntile[k] = (off[k + 1] - off[k] + ts - 1) / ts;
      total += ntile[k];
    }
  }
  // tile t: its class k, first slot s0 and n <= ts slots
  __device__ void at(int t, int ts, int& k, int& s0, int& n) const {
    k = 0;
    while (t >= ntile[k]) t -= ntile[k++];
    s0 = off[k] + t * ts;
    n = min(ts, off[k + 1] - s0);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l & 7 of matrix l >> 3
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for a 16 x 16 bf16 A fragment, a 16 x 8 B fragment (b0, b1) and
// a 16 x 8 f32 accumulator
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Address of lane's row for an A fragment (16 x 16 at (m0, k0)) of a
// row-major [M, K] tile with stride s: matrices (m0, k0), (m0+8, k0),
// (m0, k0+8), (m0+8, k0+8).
template <typename T>
__device__ __forceinline__ const T* a_rows(const T* t, int s, int m0, int k0,
                                           int lane) {
  return t + (size_t)(m0 + (lane & 15)) * s + k0 + ((lane >> 4) << 3);
}
// ... of two B fragments (n8 tiles n0, n0 + 8, depth 16 at k0) of a
// row-major [N, K] tile (B stored by columns): for ldsm_x4, giving
// (b0, b1) of tile n0, then of tile n0 + 8.
template <typename T>
__device__ __forceinline__ const T* bt_rows(const T* t, int s, int n0, int k0,
                                            int lane) {
  return t + (size_t)(n0 + (lane & 7) + ((lane >> 4) << 3)) * s + k0 +
         (((lane >> 3) & 1) << 3);
}
// ... of two B fragments of a row-major [K, N] tile, for ldsm_x4_t.
template <typename T>
__device__ __forceinline__ const T* b_rows(const T* t, int s, int n0, int k0,
                                           int lane) {
  return t + (size_t)(k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * s + n0 +
         ((lane >> 4) << 3);
}
// ... of an A fragment (16 x 16 at (m0, k0)) of a row-major [K, M] tile
// (A stored by columns), for ldsm_x4_t.
template <typename T>
__device__ __forceinline__ const T* at_rows(const T* t, int s, int m0, int k0,
                                            int lane) {
  return t + (size_t)(k0 + (lane & 7) + ((lane >> 4) << 3)) * s + m0 +
         (((lane >> 3) & 1) << 3);
}

// One PE direction pair's layer-1 outputs for unit d of class k (the same
// expression wherever the kernels recompute it).
__device__ __forceinline__ void layer1(const float* __restrict__ w1,
                                       const float* __restrict__ b1, int k,
                                       int dh, int d, float a0, float a1,
                                       float& pa, float& pb) {
  const float wa = w1[(k * 2) * dh + d], wb = w1[(k * 2 + 1) * dh + d];
  const float bb = b1[k * dh + d];
  pa = __fadd_rn(__fmaf_rn(a0, wa, __fmul_rn(a1, wb)), bb);
  pb = __fadd_rn(__fmaf_rn(a1, wa, __fmul_rn(a0, wb)), bb);
}

// A warp's LayerNorm statistics of one slot over all dh units: (mean,
// rsqrt factor) of each direction, two-pass as the reference.
__device__ __forceinline__ void ln_stats(const float* __restrict__ w1,
                                         const float* __restrict__ b1, int k,
                                         int dh, int lane, float a0, float a1,
                                         float* st) {
  float sa = 0.f, sb = 0.f;
  for (int d = lane; d < dh; d += 32) {
    float pa, pb;
    layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
    sa = __fadd_rn(sa, pa);
    sb = __fadd_rn(sb, pb);
  }
  const float mua = warp_sum(sa) / dh, mub = warp_sum(sb) / dh;
  float va = 0.f, vb = 0.f;
  for (int d = lane; d < dh; d += 32) {
    float pa, pb;
    layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
    const float ca = __fsub_rn(pa, mua), cb = __fsub_rn(pb, mub);
    va = __fmaf_rn(ca, ca, va);
    vb = __fmaf_rn(cb, cb, vb);
  }
  st[0] = mua;
  st[1] = rsqrtf(__fadd_rn(warp_sum(va) / dh, kLnEps));
  st[2] = mub;
  st[3] = rsqrtf(__fadd_rn(warp_sum(vb) / dh, kLnEps));
}

// One direction's hidden activation relu(xhat g + b) from its layer-1
// output p and statistics (mu, inv).
__device__ __forceinline__ float ln_relu(float p, float mu, float inv,
                                         float gg, float bn) {
  return fmaxf(__fmaf_rn(__fmul_rn(__fsub_rn(p, mu), inv), gg, bn), 0.f);
}

// Copies W2f_k rows [d0, d0 + nr) into shared memory [nr, ws] with the
// whole block, zeros past dh and past O (up to pad16(O)); 16-byte copies
// when a row holds whole 16-byte chunks.
template <typename T>
__device__ void stage_w(const T* __restrict__ wk, T* dst, int d0, int nr,
                        int dh, int O, int ws) {
  constexpr int vw = 16 / sizeof(T);
  const int op = pad16(O);
  if (O % vw == 0) {
    const int per = op / vw;
    for (int i = threadIdx.x; i < nr * per; i += blockDim.x) {
      const int r = i / per, c = (i % per) * vw, d = d0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (d < dh && c < O)
        v = __ldg(reinterpret_cast<const uint4*>(wk + (size_t)d * O + c));
      *reinterpret_cast<uint4*>(dst + (size_t)r * ws + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < nr * op; i += blockDim.x) {
      const int r = i / op, c = i % op, d = d0 + r;
      if (d < dh && c < O)
        dst[(size_t)r * ws + c] = wk[(size_t)d * O + c];
      else
        from_f32(0.f, dst + (size_t)r * ws + c);
    }
  }
}

// 16 / sizeof(T) consecutive elements as floats, one 16-byte read-only load
// (16-byte aligned p)
__device__ __forceinline__ void load16(const float* p, float* o) {
  load4(p, o);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// (b) X[:, :] (+)= [Ha | Hb][:, d0 + (0 .. nr)] [W ; W] over the staged W2f
// rows d0 .. d0 + nr (wsm [nr, ws]); H [TS, hs] with Hb from column dp;
// X f32 [TS, xs], zeroed first when `first`, else added to. Columns to
// pad16(O). Each element's products are added in one order whatever the
// chunks: 16 units at a time, Ha's before Hb's (bf16), or unit by unit
// (f32, where h is not rounded, so each unit's ha + hb is formed first and
// multiplied once: half the FMAs).
template <typename T, int TS>
__device__ void product_x(const T* H, int hs, int dp, const T* W, int ws,
                          float* X, int xs, int op, int d0, int nr,
                          bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    // a lane per 4 rows x 4 columns (a warp's lanes side by side along a
    // 128-column group), 4 units at a time: each 16-byte h read (a
    // broadcast) serves 4 columns and each 16-byte W read 4 rows
    const int nrg = TS / 4, items = nrg * ((op + 127) / 128);
    for (int it = warp; it < items; it += tile_warps(TS)) {
      const int r0 = (it % nrg) * 4, c = (it / nrg) * 128 + 4 * lane;
      if (c >= op) continue;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            first ? make_float4(0.f, 0.f, 0.f, 0.f)
                  : *reinterpret_cast<const float4*>(
                        X + (size_t)(r0 + i) * xs + c);
        acc[i][0] = v.x;
        acc[i][1] = v.y;
        acc[i][2] = v.z;
        acc[i][3] = v.w;
      }
      for (int d = 0; d < nr; d += 4) {
        float ha[4][4], hb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* h = H + (size_t)(r0 + i) * hs + d0 + d;
          const float4 a4 = *reinterpret_cast<const float4*>(h);
          const float4 b4 = *reinterpret_cast<const float4*>(h + dp);
          ha[i][0] = a4.x; ha[i][1] = a4.y; ha[i][2] = a4.z; ha[i][3] = a4.w;
          hb[i][0] = b4.x; hb[i][1] = b4.y; hb[i][2] = b4.z; hb[i][3] = b4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(W + (size_t)(d + u) * ws + c);
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hsum = __fadd_rn(ha[i][u], hb[i][u]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = __fmaf_rn(hsum, w[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(X + (size_t)(r0 + i) * xs + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  } else {
    const int nmt = TS / 16, items = nmt * ((op + 63) / 64);
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    for (int it = warp; it < items; it += tile_warps(TS)) {
      const int m0 = (it % nmt) * 16, n0 = (it / nmt) * 64;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + 8 * j + t2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v =
              (first || c >= op)
                  ? make_float2(0.f, 0.f)
                  : *reinterpret_cast<const float2*>(
                        X + (size_t)(m0 + g + 8 * h) * xs + c);
          acc[j][2 * h] = v.x;
          acc[j][2 * h + 1] = v.y;
        }
      }
      for (int kk = 0; kk < nr; kk += 16) {
        uint32_t fa[4], fb[4];
        ldsm_x4(fa, a_rows(H, hs, m0, d0 + kk, lane));
        ldsm_x4(fb, a_rows(H, hs, m0, dp + d0 + kk, lane));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (n0 + 8 * j < op) {
            uint32_t b[4];
            ldsm_x4_t(b, b_rows(W, ws, n0 + 8 * j, kk, lane));
            mma_bf16(acc[j], fa, b[0], b[1]);
            mma_bf16(acc[j], fb, b[0], b[1]);
            mma_bf16(acc[j + 1], fa, b[2], b[3]);
            mma_bf16(acc[j + 1], fb, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + 8 * j + t2;
        if (c < op) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(X + (size_t)(m0 + g + 8 * h) * xs + c) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }
  }
}

// The tile prologue up to xj: the n rows of tile (k, s0) read, (a), (b)
// and (c) above; on return (after a barrier) X [TS, xs] holds each row's
// xj and rf each row's PPR values and LayerNorm statistics. The key of
// slot s is row ids[s] of keys [N', O], or row s of keys [B C, O] when ids
// is null. w_class is the class whose W2f sits in wsm (-1 before a
// block's first tile).
template <typename T, int TS>
__device__ __forceinline__ void tile_xj(
    const T* __restrict__ keys, const int32_t* __restrict__ ids,
    const float* __restrict__ ps,
    const float* __restrict__ pt, const int32_t* __restrict__ slots,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ bln,
    const T* __restrict__ w2f, const float* __restrict__ cbias,
    const TileSmem& L, const TilePtrs<T>& p, int k, int s0, int n, int C,
    int& w_class) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int O = L.O, dh = L.dh, dc = L.dc;
  const int ws = L.ws(), hs = L.hs(), xs = L.xs();
  const int dp = pad16(dh), op = pad16(O);
  const bool resident = dc >= dp;
  const T* wk = w2f + (size_t)k * dh * O;
  float* rf = p.rf;

  // the rows' slots, links, key rows and PPR values, every row at once
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int slot = slots[s0 + r];
    p.rslot[r] = slot;
    p.rlink[r] = slot / C;
    rf[kKeyRow * TS + r] = __int_as_float(ids ? ids[slot] : slot);
    rf[kA0 * TS + r] = ps[slot];
    rf[kA1 * TS + r] = pt[slot];
  }
  __syncthreads();

  // (a) each slot's LayerNorm, [Ha | Hb] in W2f's type
  for (int r = warp; r < TS; r += tile_warps(TS)) {
    T* h = p.hx + (size_t)r * hs;
    if (r >= n) {
      for (int d = lane; d < 2 * dp; d += 32) from_f32(0.f, h + d);
      continue;
    }
    const float a0 = rf[kA0 * TS + r], a1 = rf[kA1 * TS + r];
    float st[4];
    ln_stats(w1, b1, k, dh, lane, a0, a1, st);
    for (int d = lane; d < dp; d += 32) {
      float ha = 0.f, hb = 0.f;
      if (d < dh) {
        float pa, pb;
        layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
        const float gg = g[k * dh + d], bn = bln[k * dh + d];
        ha = ln_relu(pa, st[0], st[1], gg, bn);
        hb = ln_relu(pb, st[2], st[3], gg, bn);
      }
      from_f32(ha, h + d);
      from_f32(hb, h + dp + d);
    }
    if (lane == 0) {
      rf[kMuA * TS + r] = st[0];
      rf[kInvA * TS + r] = st[1];
      rf[kMuB * TS + r] = st[2];
      rf[kInvB * TS + r] = st[3];
    }
  }
  if (resident && w_class != k) {
    stage_w(wk, p.wsm, 0, dp, dh, O, ws);
    w_class = k;
  }
  __syncthreads();

  // (b) X = [Ha | Hb] [W2f_k ; W2f_k]
  for (int d0 = 0; d0 < dp; d0 += dc) {
    const int nr = min(dc, dp - d0);
    if (!resident) {
      __syncthreads();
      stage_w(wk, p.wsm, d0, nr, dh, O, ws);
      __syncthreads();
    }
    product_x<T, TS>(p.hx, hs, dp, p.wsm, ws, p.xd, xs, op, d0, nr, d0 == 0);
  }
  __syncthreads();

  // (c) xj = X + keys + cbias_k, the key rows read by every thread at once
  {
    constexpr int vw = 16 / sizeof(T);
    const bool vec = O % vw == 0;
    const int per = vec ? O / vw : O;
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int r = i / per, c = (i % per) * (vec ? vw : 1);
      const T* kr =
          keys + (size_t)__float_as_int(rf[kKeyRow * TS + r]) * O + c;
      float* x = p.xd + (size_t)r * xs + c;
      const float* cb = cbias + k * O + c;
      if (vec) {
        float kv[vw];
        load16(kr, kv);
#pragma unroll
        for (int e = 0; e < vw; ++e)
          x[e] = __fadd_rn(x[e], __fadd_rn(kv[e], cb[e]));
      } else {
        x[0] = __fadd_rn(x[0], __fadd_rn(to_f32(kr[0]), cb[0]));
      }
    }
  }
  __syncthreads();
}

// A warp's logit of one row, xj x [O] of link row qb [O]: s = sum_o att[o]
// lrelu(x[o] qb[o]), lane by lane over the columns lane + 32 j, then
// across the warp (every lane gets s). With kDot (the backward) the same
// walk also sums gx = sum_o gb[o] x[o]; s's roundings are pinned, so it
// comes out the same either way.
template <bool kDot>
__device__ __forceinline__ float row_logit(const float* x,
                                           const float* __restrict__ qb,
                                           const float* __restrict__ att,
                                           int O, int lane,
                                           const float* __restrict__ gb,
                                           float& gx) {
  float part = 0.f, gpart = 0.f;
  for (int o = lane; o < O; o += 32) {
    const float v = x[o];
    const float pre = __fmul_rn(v, qb[o]);
    part = __fmaf_rn(att[o], pre >= 0.f ? pre : __fmul_rn(0.2f, pre), part);
    if (kDot) gpart += gb[o] * v;
  }
  if (kDot) gx = warp_sum(gpart);
  return warp_sum(part);
}

// A slot's softmax weight from its logit and its link's statistics.
__device__ __forceinline__ float softmax_weight(float s, float m, float l) {
  return expf(s - m) / fmaxf(l, 1e-16f);
}

// rows [r0, r1) of n that part `part` of `parts` walks
__device__ __forceinline__ void row_split(int n, int parts, int part, int& r0,
                                          int& r1) {
  const int per = (n + parts - 1) / parts;
  r0 = min(n, part * per);
  r1 = min(n, r0 + per);
}

// W2f rows a tile kernel stages in shared memory at once: all of them
// where they fit beside the backward's tile, else a multiple of 16; 0 when
// not even 16 rows fit. Both directions take this count, so they stage
// and multiply W2f in the same chunks.
inline int w2_rows(int ts, int O, int dh, int K, int elem) {
  const TileSmem L{ts, O, dh, 0, elem, bwd_sums(K, O, dh)};
  const size_t cap = block_smem_cap(1);
  const size_t row = (size_t)L.ws() * elem;
  if (cap < L.fixed_bytes() + 16 * row) return 0;
  const int dc = (int)((cap - L.fixed_bytes()) / row) / 16 * 16;
  return dc < pad16(dh) ? dc : pad16(dh);
}

// A tile kernel's launch: its shared memory (W2f in w2_rows' chunks, n_acc
// sums), two resident blocks per SM where the SM's shared memory holds
// them (at most 2: registers), and a persistent grid of at most one block
// per possible tile (B C / TS + K: every class may end with a part tile).
struct TileLaunch {
  TileSmem L;
  size_t smem = 0;
  int grid = 0, sms = 0;
};

template <typename Kern>
cudaError_t tile_launch(Kern kern, int ts, int O, int dh, int K, int elem,
                        int n_acc, long long slots, TileLaunch* out) {
  const int dc = w2_rows(ts, O, dh, K, elem);
  if (dc < 16) return cudaErrorInvalidValue;
  out->L = TileSmem{ts, O, dh, dc, elem, n_acc};
  out->smem = out->L.total();
  int dev = 0, sm_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  const int blocks = sm_bytes >= 2 * (int)(out->smem + 1024) ? 2 : 1;
  const int max_tiles = (int)((slots + ts - 1) / ts) + K;
  return persistent_grid(kern, 32 * tile_warps(ts), out->smem, blocks,
                         max_tiles, &out->grid, &out->sms);
}

}  // namespace
