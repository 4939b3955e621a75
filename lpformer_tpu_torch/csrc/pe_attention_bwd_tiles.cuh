// Fused PE + per-link attention, backward pass, for Hopper (sm_90a), as
// class-uniform tiles of compacted valid slots: the kernels behind both
// context-table layouts' backward, csrc/pe_attention_bwd.cu (the classic
// class-blocked table) and csrc/pe_attention_mixed_bwd.cu (the combined
// class-tagged table).
//
// Replaces the TPU kernels lpformer_tpu/ops/pallas/pe_attention.py:
// _bwd_kernel (:244, with _dir_bwd :219) behind _bwd_call (:367), reached
// from the custom VJP _fused_bwd (:460), and
// lpformer_tpu/ops/pallas/pe_attention_mixed.py: _bwd_kernel (:250, with
// _dir_bwd_mixed :221) behind _bwd_call (:366), reached from _fused_bwd
// (:468).
//
// Math. The forward, for each link b and each valid slot c of class k:
//   g_k(x) = relu(y),  y = LN_k(x @ W1_k + b1_k)   (LN eps 1e-5, gain g_k,
//            bias b_k; h = g_k(x) rounded to W2f's type)
//   xj     = keys[b,c] + ha W2f_k + hb W2f_k + cbias_k,  with ha = g_k([ps,
//            pt]) and hb = g_k([pt, ps]) (ps, pt the slot's PPR values)
//   s      = sum_o att[o] lrelu(xj[o] q[b,o]),  lrelu the leaky ReLU (0.2)
//   out[b] = sum_c softmax_c(s) xj + bias
// The backward recomputes each valid slot's forward from the saved softmax
// statistics m, l, then with g_out [B, O] and delta[b] = g_out[b] .
// (out[b] - bias):
//   alpha  = exp(s - m) / max(l, 1e-16),  dlogit = alpha (g_out . xj - delta)
//   dxj    = alpha g_out + dlogit att lrelu'(xj q) q;  dkeys = dxj (keys' type)
//   dq += dlogit att lrelu'(xj q) xj;  datt += dlogit lrelu(xj q);  dcb_k += dxj
//   dxjc = dxj rounded to W2f's type
//   dw2_k += ha^T dxjc + hb^T dxjc;  dh = dxjc W2f_k^T (both directions)
//   dya = dh [ya > 0], dyb = dh [yb > 0];  dg_k += dya xhat_a + dyb xhat_b;
//   db_k += dya + dyb;  each direction's LayerNorm backward
//   dp = rsqrt(var + eps) (dy g - mean(dy g) - xhat mean(dy g xhat)), and
//   the packed layer-1 rows: dw1a_k += ps dpa + pt dpb, dw1b_k += pt dpa +
//   ps dpb, db1_k += dpa + dpb.
//
// What bounds it on an H100: the bytes of dkeys [B, C, O], most of it the
// dead slots' zero rows (335 MB at the collab-like classic shape, 134 MB
// at the collab-like combined one, bf16), which the wrapper writes with
// one memset; the valid slots' three dh x O products are microseconds of
// tensor-core time.
//
// Design. The wrapper lists the valid slots in (class, link, column) order
// with the classes' offsets on the device (device ops, no host sync):
// ops/pe_attention_mixed.py:compact_tagged_slots, from the combined table's
// class tags or the classic table's column blocks. Nothing here asks where
// a slot's class comes from: a tile's class is its place in that list.
//   * main kernel: a persistent block takes tiles of TS slots of one class
//     (64 with 8 warps, two blocks an SM; or, when O or dh passes 128, 32
//     with 16 warps, one block an SM). Per tile, after every thread has
//     read a row's slot id and PPR values at once:
//     (a) a warp per slot recomputes both directions' LayerNorm and keeps
//         [Ha | Hb], TS x 2 dh in W2f's type, in shared memory;
//     (b) X = [Ha | Hb] [W2f_k ; W2f_k] on the tensor cores (mma.sync
//         m16n8k16 bf16, f32 accumulate): each direction's rounded h is
//         multiplied separately, as the TPU kernel and the plain version do;
//     (c) every thread adds keys (16-byte reads) and cbias, a warp per
//         slot takes the row sums (alpha, dlogit); then a thread per
//         column walks the tile's rows (q, g_out a row ahead): dxj to
//         dkeys and, rounded, to a TS x O tile; dq summed along each link's
//         run of rows, one f32 atomic per (run, column); dcb, datt summed;
//     (d) dH = dxjc W2f_k^T on the tensor cores;
//     (e) a warp per slot takes the LayerNorm backward's row means, then a
//         thread per hidden unit walks the rows summing the grads of g, b
//         and the layer-1 rows; each tile's sums go into the block's
//         shared-memory sums, flushed with one f32 atomic per element and
//         block at its end.
//     W2f_k sits in shared memory for the class's run of tiles where it
//     fits (every width the presets use in bf16), else it is staged in row
//     chunks per product.
//   * dw2 kernel: a grouped product with split K: block (chunk, (k, 128 x
//     128 tile of (dh, O))) takes a chunk of class k's slots, 64 at a
//     time, recomputes [Ha | Hb] for its units, reads dxjc back from the
//     dkeys rows with every thread at once (dkeys is dxj in the keys'
//     type, W2f's type: the same rounding) and adds Ha^T dxjc + Hb^T dxjc
//     on the tensor cores; one f32 atomic per element and block.
// f32 inputs run the same tiles with the products as f32 FMA loops on the
// CUDA cores (not TF32). Sums across blocks go through f32 atomics, so the
// order of the additions changes from run to run.
#pragma once

#include <type_traits>

#include "pe_attention_common.cuh"

namespace {

constexpr int kDw2Threads = 256;    // dw2 kernel: 8 warps
constexpr int kDw2T = 128;      // units and columns of a dw2 block's tile
constexpr int kDw2Slots = 64;   // slots a dw2 block takes at a time

// per-row fields of a tile, [kRowF][TS] floats
enum RowField { kA0, kA1, kMuA, kInvA, kMuB, kInvB, kAlpha, kDlog, kM1A,
                kM2A, kM1B, kM2B, kRowF };

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Warps of a main-kernel block with tiles of TS slots: 8 for 64 (two
// blocks share an SM), 16 for 32 (one block fills an SM's shared memory
// at O = dh = 256, so it brings its own warps).
__host__ __device__ constexpr int tile_warps(int ts) { return ts == 32 ? 16 : 8; }

// Row stride in elements of a shared-memory tile with n columns of
// `elem`-byte elements: n padded to 16, plus 16 bytes, so the eight rows
// an ldmatrix reads start on distinct banks.
__host__ __device__ constexpr int tile_stride(int n, int elem) {
  return pad16(n) + 16 / elem;
}

// The main kernel's shared memory: W2f_k rows [dc, O]; [Ha | Hb]
// [TS, 2 pad16(dh)], which dxjc [TS, O] then reuses; X, then dH, f32
// [TS, max(O, dh)]; the rows' slot and link ids and fields; the block's
// weight-grad sums (dw1cat [3K, dh], dg, db [K, dh], dcb [K, O], datt [O]).
struct TileSmem {
  int ts, O, dh, K, dc, elem;
  __host__ __device__ int ws() const { return tile_stride(O, elem); }
  __host__ __device__ int hs() const { return tile_stride(2 * pad16(dh), elem); }
  __host__ __device__ int xs() const { return imax(pad16(O), pad16(dh)) + 4; }
  __host__ __device__ int n_acc() const { return 5 * K * dh + K * O + O; }
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
    return hx_bytes() + xd_bytes() + row_bytes() + align16(4 * (size_t)n_acc());
  }
  __host__ __device__ size_t total() const { return w_bytes() + fixed_bytes(); }
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
  pa = a0 * wa + a1 * wb + bb;
  pb = a1 * wa + a0 * wb + bb;
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
    sa += pa;
    sb += pb;
  }
  const float mua = warp_sum(sa) / dh, mub = warp_sum(sb) / dh;
  float va = 0.f, vb = 0.f;
  for (int d = lane; d < dh; d += 32) {
    float pa, pb;
    layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
    va += (pa - mua) * (pa - mua);
    vb += (pb - mub) * (pb - mub);
  }
  st[0] = mua;
  st[1] = rsqrtf(warp_sum(va) / dh + kLnEps);
  st[2] = mub;
  st[3] = rsqrtf(warp_sum(vb) / dh + kLnEps);
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
// pad16(O).
template <typename T, int TS>
__device__ void product_x(const T* H, int hs, int dp, const T* W, int ws,
                          float* X, int xs, int op, int d0, int nr,
                          bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < TS * op; e += blockDim.x) {
      const int r = e / op, o = e % op;
      const float* h = H + (size_t)r * hs + d0;
      float acc = first ? 0.f : X[(size_t)r * xs + o];
      for (int d = 0; d < nr; ++d) {
        const float w = W[(size_t)d * ws + o];
        acc += h[d] * w;
        acc += h[dp + d] * w;
      }
      X[(size_t)r * xs + o] = acc;
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

// (d) dH[:, d0 + (0 .. nr)] = dxjc W^T over the staged W2f rows d0 .. d0 +
// nr (wsm [nr, ws]); dxjc D [TS, ds] (zero past O up to pad16(O)); dH
// f32 [TS, xs].
template <typename T, int TS>
__device__ void product_dh(const T* D, int ds, const T* W, int ws, float* X,
                           int xs, int op, int d0, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < TS * nr; e += blockDim.x) {
      const int r = e / nr, n = e % nr;
      const float* dx = D + (size_t)r * ds;
      const float* w = W + (size_t)n * ws;
      float acc = 0.f;
      // the lanes start at different columns: W's rows then fall on
      // distinct banks
      for (int i = 0, o = lane % op; i < op; ++i, o = (o + 1 == op ? 0 : o + 1))
        acc += dx[o] * w[o];
      X[(size_t)r * xs + d0 + n] = acc;
    }
  } else {
    const int nmt = TS / 16, items = nmt * ((nr + 63) / 64);
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    for (int it = warp; it < items; it += tile_warps(TS)) {
      const int m0 = (it % nmt) * 16, n0 = (it / nmt) * 64;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int kk = 0; kk < op; kk += 16) {
        uint32_t fa[4];
        ldsm_x4(fa, a_rows(D, ds, m0, kk, lane));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (n0 + 8 * j < nr) {
            uint32_t b[4];
            ldsm_x4(b, bt_rows(W, ws, n0 + 8 * j, kk, lane));
            mma_bf16(acc[j], fa, b[0], b[1]);
            mma_bf16(acc[j + 1], fa, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + 8 * j + t2;
        if (c < nr) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(X + (size_t)(m0 + g + 8 * h) * xs +
                                       d0 + c) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }
  }
}

// rows [r0, r1) of n that part `part` of `parts` walks
__device__ __forceinline__ void row_split(int n, int parts, int part, int& r0,
                                          int& r1) {
  const int per = (n + parts - 1) / parts;
  r0 = min(n, part * per);
  r1 = min(n, r0 + per);
}

template <typename T, int TS>
__global__ void __launch_bounds__(32 * tile_warps(TS))
pe_tiles_bwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ ps,
    const float* __restrict__ pt, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ offsets, const float* __restrict__ q,
    const float* __restrict__ g_out, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ delta_in,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ bln,
    const T* __restrict__ w2f, const float* __restrict__ cbias,
    const float* __restrict__ att, T* __restrict__ dkeys,
    float* __restrict__ dq, float* __restrict__ dw1cat,
    float* __restrict__ dg, float* __restrict__ db,
    float* __restrict__ dcb, float* __restrict__ datt, int C, int O, int dh,
    int K, int dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem L{TS, O, dh, K, dc, (int)sizeof(T)};
  T* wsm = reinterpret_cast<T*>(smem_raw);
  T* hx = reinterpret_cast<T*>(smem_raw + L.w_bytes());
  float* xd = reinterpret_cast<float*>(smem_raw + L.w_bytes() + L.hx_bytes());
  int* rslot = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(xd) +
                                      L.xd_bytes());
  int* rlink = rslot + TS;
  float* rf = reinterpret_cast<float*>(rlink + TS);          // [kRowF][TS]
  float* acc_w1 = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(rslot) + L.row_bytes());  // [3K, dh]
  float* acc_g = acc_w1 + 3 * K * dh;                         // [K, dh]
  float* acc_b = acc_g + K * dh;                              // [K, dh]
  float* acc_cb = acc_b + K * dh;                             // [K, O]
  float* acc_att = acc_cb + K * O;                            // [O]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ws = L.ws(), hs = L.hs(), xs = L.xs();
  const int dp = pad16(dh), op = pad16(O);
  const bool resident = dc >= dp;

  for (int i = threadIdx.x; i < L.n_acc(); i += blockDim.x) acc_w1[i] = 0.f;
  int off[4] = {0, 0, 0, 0}, ntile[3] = {0, 0, 0}, total = 0;
  for (int k = 0; k <= K; ++k) off[k] = offsets[k];
  for (int k = 0; k < K; ++k) {
    ntile[k] = (off[k + 1] - off[k] + TS - 1) / TS;
    total += ntile[k];
  }
  int w_class = -1;     // the class whose W2f sits in wsm
  __syncthreads();

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int k = 0, tt = t;
    while (tt >= ntile[k]) tt -= ntile[k++];
    const int s0 = off[k] + tt * TS, n = min(TS, off[k + 1] - s0);
    const T* wk = w2f + (size_t)k * dh * O;

    // the rows' slots, links and PPR values, every row at once
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int slot = slots[s0 + r];
      rslot[r] = slot;
      rlink[r] = slot / C;
      rf[kA0 * TS + r] = ps[slot];
      rf[kA1 * TS + r] = pt[slot];
    }
    __syncthreads();

    // (a) each slot's LayerNorm, [Ha | Hb] in W2f's type
    for (int r = warp; r < TS; r += tile_warps(TS)) {
      T* h = hx + (size_t)r * hs;
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
          ha = fmaxf((pa - st[0]) * st[1] * gg + bn, 0.f);
          hb = fmaxf((pb - st[2]) * st[3] * gg + bn, 0.f);
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
      stage_w(wk, wsm, 0, dp, dh, O, ws);
      w_class = k;
    }
    __syncthreads();

    // (b) X = [Ha | Hb] [W2f_k ; W2f_k]
    for (int d0 = 0; d0 < dp; d0 += dc) {
      const int nr = min(dc, dp - d0);
      if (!resident) {
        __syncthreads();
        stage_w(wk, wsm, d0, nr, dh, O, ws);
        __syncthreads();
      }
      product_x<T, TS>(hx, hs, dp, wsm, ws, xd, xs, op, d0, nr, d0 == 0);
    }
    __syncthreads();

    // (c) xj = X + keys + cbias_k, the key rows read by every thread at
    // once; then each row's alpha and dlogit
    {
      constexpr int vw = 16 / sizeof(T);
      const bool vec = O % vw == 0;
      const int per = vec ? O / vw : O;
      for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
        const int r = i / per, c = (i % per) * (vec ? vw : 1);
        const T* kr = keys + (size_t)rslot[r] * O + c;
        float* x = xd + (size_t)r * xs + c;
        const float* cb = cbias + k * O + c;
        if (vec) {
          float kv[vw];
          load16(kr, kv);
#pragma unroll
          for (int e = 0; e < vw; ++e) x[e] += kv[e] + cb[e];
        } else {
          x[0] += to_f32(kr[0]) + cb[0];
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < n; r += tile_warps(TS)) {
      const int b = rlink[r];
      const float* x = xd + (size_t)r * xs;
      float part = 0.f, gpart = 0.f;
      for (int o = lane; o < O; o += 32) {
        const float v = x[o];
        const float pre = v * q[(size_t)b * O + o];
        part += att[o] * (pre >= 0.f ? pre : 0.2f * pre);
        gpart += g_out[(size_t)b * O + o] * v;
      }
      const float s = warp_sum(part), galpha = warp_sum(gpart);
      if (lane == 0) {
        const float alpha = expf(s - m_in[b]) / fmaxf(l_in[b], 1e-16f);
        rf[kAlpha * TS + r] = alpha;
        rf[kDlog * TS + r] = alpha * (galpha - delta_in[b]);
      }
    }
    __syncthreads();

    // ... then a thread per column walks its share of the rows: dkeys,
    // dxjc (over [Ha | Hb], now dead), dq per link run, dcb and datt
    T* dxc = hx;
    {
      const int parts = O < (int)blockDim.x ? blockDim.x / O : 1;
      for (int w = threadIdx.x; w < parts * O; w += blockDim.x) {
        const int col = w % O;
        int r0, r1;
        row_split(n, parts, w / O, r0, r1);
        const float av = att[col];
        float sum_cb = 0.f, sum_att = 0.f, run = 0.f;
        int prev = -1;
        // the next row's q and g_out are loaded a row ahead
        float qn = 0.f, gn = 0.f;
        if (r0 < r1) {
          qn = q[(size_t)rlink[r0] * O + col];
          gn = g_out[(size_t)rlink[r0] * O + col];
        }
        for (int r = r0; r < r1; ++r) {
          const int b = rlink[r];
          const float qv = qn, gv = gn;
          if (r + 1 < r1) {
            qn = q[(size_t)rlink[r + 1] * O + col];
            gn = g_out[(size_t)rlink[r + 1] * O + col];
          }
          if (b != prev) {
            if (prev >= 0) atomicAdd(dq + (size_t)prev * O + col, run);
            run = 0.f;
            prev = b;
          }
          const float x = xd[(size_t)r * xs + col];
          const float alpha = rf[kAlpha * TS + r], dlog = rf[kDlog * TS + r];
          const float pre = x * qv;
          const float dpre = dlog * av * (pre >= 0.f ? 1.f : 0.2f);
          const float dxj = alpha * gv + dpre * qv;
          sum_att += dlog * (pre >= 0.f ? pre : 0.2f * pre);
          sum_cb += dxj;
          run += dpre * x;
          from_f32(dxj, dkeys + (size_t)rslot[r] * O + col);
          from_f32(dxj, dxc + (size_t)r * ws + col);
        }
        if (prev >= 0) atomicAdd(dq + (size_t)prev * O + col, run);
        atomicAdd(acc_cb + k * O + col, sum_cb);
        atomicAdd(acc_att + col, sum_att);
      }
      // zero the dxjc columns past O and rows past n (the product's padding)
      for (int i = threadIdx.x; i < TS * op; i += blockDim.x) {
        const int r = i / op, c = i % op;
        if (c >= O || r >= n) from_f32(0.f, dxc + (size_t)r * ws + c);
      }
    }
    __syncthreads();

    // (d) dH = dxjc W2f_k^T, into xd
    for (int d0 = 0; d0 < dp; d0 += dc) {
      const int nr = min(dc, dp - d0);
      if (!resident) {
        __syncthreads();
        stage_w(wk, wsm, d0, nr, dh, O, ws);
        __syncthreads();
      }
      product_dh<T, TS>(dxc, ws, wsm, ws, xd, xs, op, d0, nr);
    }
    __syncthreads();

    // (e) the LayerNorm backward: each row's means ...
    for (int r = warp; r < n; r += tile_warps(TS)) {
      const float a0 = rf[kA0 * TS + r], a1 = rf[kA1 * TS + r];
      const float mua = rf[kMuA * TS + r], inva = rf[kInvA * TS + r];
      const float mub = rf[kMuB * TS + r], invb = rf[kInvB * TS + r];
      float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
      for (int d = lane; d < dh; d += 32) {
        float pa, pb;
        layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
        const float xa = (pa - mua) * inva, xb = (pb - mub) * invb;
        const float gg = g[k * dh + d], bn = bln[k * dh + d];
        const float dhh = xd[(size_t)r * xs + d];
        const float dya = xa * gg + bn > 0.f ? dhh : 0.f;
        const float dyb = xb * gg + bn > 0.f ? dhh : 0.f;
        s1a += dya * gg;
        s2a += dya * gg * xa;
        s1b += dyb * gg;
        s2b += dyb * gg * xb;
      }
      s1a = warp_sum(s1a);
      s2a = warp_sum(s2a);
      s1b = warp_sum(s1b);
      s2b = warp_sum(s2b);
      if (lane == 0) {
        rf[kM1A * TS + r] = s1a / dh;
        rf[kM2A * TS + r] = s2a / dh;
        rf[kM1B * TS + r] = s1b / dh;
        rf[kM2B * TS + r] = s2b / dh;
      }
    }
    __syncthreads();

    // ... then a thread per hidden unit sums its grads over its rows
    {
      const int parts = dh < (int)blockDim.x ? blockDim.x / dh : 1;
      for (int w = threadIdx.x; w < parts * dh; w += blockDim.x) {
        const int d = w % dh;
        int r0, r1;
        row_split(n, parts, w / dh, r0, r1);
        const float gg = g[k * dh + d], bn = bln[k * dh + d];
        float sg = 0.f, sb = 0.f, sw0 = 0.f, sw1 = 0.f, sw2 = 0.f;
        for (int r = r0; r < r1; ++r) {
          const float a0 = rf[kA0 * TS + r], a1 = rf[kA1 * TS + r];
          float pa, pb;
          layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
          const float inva = rf[kInvA * TS + r], invb = rf[kInvB * TS + r];
          const float xa = (pa - rf[kMuA * TS + r]) * inva;
          const float xb = (pb - rf[kMuB * TS + r]) * invb;
          const float dhh = xd[(size_t)r * xs + d];
          const float dya = xa * gg + bn > 0.f ? dhh : 0.f;
          const float dyb = xb * gg + bn > 0.f ? dhh : 0.f;
          sg += dya * xa + dyb * xb;
          sb += dya + dyb;
          const float dpa =
              inva * (dya * gg - rf[kM1A * TS + r] - xa * rf[kM2A * TS + r]);
          const float dpb =
              invb * (dyb * gg - rf[kM1B * TS + r] - xb * rf[kM2B * TS + r]);
          // layer-1 input rows: direction a sees (ps, pt, 1), b (pt, ps, 1)
          sw0 += a0 * dpa + a1 * dpb;
          sw1 += a1 * dpa + a0 * dpb;
          sw2 += dpa + dpb;
        }
        atomicAdd(acc_w1 + k * dh + d, sw0);
        atomicAdd(acc_w1 + (K + k) * dh + d, sw1);
        atomicAdd(acc_w1 + (2 * K + k) * dh + d, sw2);
        atomicAdd(acc_g + k * dh + d, sg);
        atomicAdd(acc_b + k * dh + d, sb);
      }
    }
    __syncthreads();
  }

  if ((int)blockIdx.x >= total) return;
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

// dw2[k][d0 .. d0+127][o0 .. o0+127] += Ha^T dxjc + Hb^T dxjc over block
// (chunk, (k * ndc + dc) * noc + oc)'s share of class k's slots: units d0 =
// dc * 128 onwards, columns o0 = oc * 128 onwards; 64 slots at a time, a
// warp per slot for the LayerNorm (over all dh) and the dkeys row.
template <typename T>
__global__ void __launch_bounds__(kDw2Threads)
pe_tiles_dw2_kernel(
    const T* __restrict__ dkeys, const float* __restrict__ ps,
    const float* __restrict__ pt, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ offsets, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ g,
    const float* __restrict__ bln, float* __restrict__ dw2, int O, int dh,
    int ndc, int noc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int st = tile_stride(kDw2T, sizeof(T));
  T* ha = reinterpret_cast<T*>(smem_raw);      // [64, st] slots x units
  T* hb = ha + kDw2Slots * st;
  T* dx = hb + kDw2Slots * st;                 // [64, st] slots x columns
  int* sid = reinterpret_cast<int*>(dx + kDw2Slots * st);   // [64]
  float* sa0 = reinterpret_cast<float*>(sid + kDw2Slots);   // [64] ps
  float* sa1 = sa0 + kDw2Slots;                             // [64] pt
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.y / (ndc * noc), tile = blockIdx.y % (ndc * noc);
  const int d0 = (tile / noc) * kDw2T, nd = min(kDw2T, dh - d0);
  const int o0 = (tile % noc) * kDw2T, no = min(kDw2T, O - o0);
  const int lo = offsets[k], cnt = offsets[k + 1] - lo;
  // the block's share of the class's slots, whole sub-tiles
  const int per = ((cnt + gridDim.x - 1) / gridDim.x + kDw2Slots - 1) /
                  kDw2Slots * kDw2Slots;
  const int s_lo = lo + blockIdx.x * per;
  const int s_hi = min(lo + cnt, s_lo + per);
  if (s_lo >= s_hi) return;

  // bf16: warp w owns units (w % 4) * 32 .. +32 and columns (w / 4) * 64
  // .. +64 of the tile; f32: thread owns column tid % 128 and 64 units
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int s0 = s_lo; s0 < s_hi; s0 += kDw2Slots) {
    const int n = min(kDw2Slots, s_hi - s0);
    // the slots and their PPR values, every slot at once; then their
    // dxjc (the dkeys rows' tile columns), 16 bytes a thread where the
    // rows allow it, zeros past n and past O
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int slot = slots[s0 + r];
      sid[r] = slot;
      sa0[r] = ps[slot];
      sa1[r] = pt[slot];
    }
    __syncthreads();
    {
      constexpr int vw = 16 / sizeof(T);
      const bool vec = O % vw == 0;
      for (int i = threadIdx.x; i < kDw2Slots * (kDw2T / vw);
           i += blockDim.x) {
        const int r = i / (kDw2T / vw), c = (i % (kDw2T / vw)) * vw;
        T* dst = dx + r * st + c;
        const T* src = dkeys + (size_t)(r < n ? sid[r] : 0) * O + o0 + c;
        if (vec && r < n && c + vw <= no) {
          *reinterpret_cast<uint4*>(dst) =
              __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          for (int e = 0; e < vw; ++e) {
            if (r < n && c + e < no)
              dst[e] = src[e];
            else
              from_f32(0.f, dst + e);
          }
        }
      }
    }
    for (int r = warp; r < kDw2Slots; r += kDw2Threads / 32) {
      T* har = ha + r * st;
      T* hbr = hb + r * st;
      if (r >= n) {
        for (int c = lane; c < kDw2T; c += 32) {
          from_f32(0.f, har + c);
          from_f32(0.f, hbr + c);
        }
        continue;
      }
      const float a0 = sa0[r], a1 = sa1[r];
      float stt[4];
      ln_stats(w1, b1, k, dh, lane, a0, a1, stt);
      for (int c = lane; c < kDw2T; c += 32) {
        const int d = d0 + c;
        float va = 0.f, vb = 0.f;
        if (c < nd) {
          float pa, pb;
          layer1(w1, b1, k, dh, d, a0, a1, pa, pb);
          const float gg = g[k * dh + d], bn = bln[k * dh + d];
          va = fmaxf((pa - stt[0]) * stt[1] * gg + bn, 0.f);
          vb = fmaxf((pb - stt[2]) * stt[3] * gg + bn, 0.f);
        }
        from_f32(va, har + c);
        from_f32(vb, hbr + c);
      }
    }
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
      const int col = threadIdx.x & (kDw2T - 1), half = threadIdx.x / kDw2T;
      for (int s = 0; s < n; ++s) {
        const float v = dx[s * st + col];
        const float* a = ha + s * st + half * 64;
        const float* b = hb + s * st + half * 64;
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(a + i);
          const float4 b4 = *reinterpret_cast<const float4*>(b + i);
          acc[i] += a4.x * v;
          acc[i] += b4.x * v;
          acc[i + 1] += a4.y * v;
          acc[i + 1] += b4.y * v;
          acc[i + 2] += a4.z * v;
          acc[i + 2] += b4.z * v;
          acc[i + 3] += a4.w * v;
          acc[i + 3] += b4.w * v;
        }
      }
    } else {
      const int mb = (warp & 3) * 32, nb = (warp >> 2) * 64;
      for (int kk = 0; kk < kDw2Slots; kk += 16) {
        uint32_t b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldsm_x4_t(b[j], b_rows(dx, st, nb + 16 * j, kk, lane));
#pragma unroll
        for (int dir = 0; dir < 2; ++dir) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            uint32_t a[4];
            ldsm_x4_t(a, at_rows(dir ? hb : ha, st, mb + 16 * mi, kk, lane));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma_bf16(acc + (mi * 8 + 2 * j) * 4, a, b[j][0], b[j][1]);
              mma_bf16(acc + (mi * 8 + 2 * j + 1) * 4, a, b[j][2], b[j][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = dw2 + ((size_t)k * dh + d0) * O + o0;
  if constexpr (std::is_same<T, float>::value) {
    const int col = threadIdx.x & (kDw2T - 1), half = threadIdx.x / kDw2T;
    if (col < no) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int d = half * 64 + i;
        if (d < nd) atomicAdd(out + (size_t)d * O + col, acc[i]);
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
            atomicAdd(out + (size_t)d * O + c, acc[(mi * 8 + j) * 4 + i]);
        }
  }
}

// Launch the main kernel with tiles of TS slots, then the dw2 kernel, on
// `stream`; returns cudaGetLastError() after the launches (0 = ok).
template <typename T, int TS>
int launch_tiles(const void* keys, const void* ps, const void* pt,
                 const void* slots, const void* offsets, const void* q,
                 const void* g_out, const void* m, const void* l,
                 const void* delta, const void* w1, const void* b1,
                 const void* g, const void* bln, const void* w2f,
                 const void* cbias, const void* att, void* dkeys, void* dq,
                 void* dw1cat, void* dg, void* db, void* dcb, void* datt,
                 void* dw2, int B, int C, int O, int dh, int K,
                 cudaStream_t stream) {
  TileSmem L{TS, O, dh, K, 0, (int)sizeof(T)};
  const size_t cap = block_smem_cap(1);
  const size_t row = (size_t)L.ws() * sizeof(T);
  if (cap < L.fixed_bytes() + 16 * row) return (int)cudaErrorInvalidValue;
  // W2f rows staged at once: all of them where they fit, else a multiple
  // of 16
  L.dc = (int)((cap - L.fixed_bytes()) / row) / 16 * 16;
  if (L.dc > pad16(dh)) L.dc = pad16(dh);
  const size_t smem = L.total();
  auto kern = pe_tiles_bwd_kernel<T, TS>;
  // resident blocks per SM: as many as the SM's shared memory holds, at
  // most 2 (registers)
  int dev = 0, sm_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sm_bytes >= 2 * (int)(smem + 1024) ? 2 : 1;
  int grid = 0, sms = 0;
  const int max_tiles = (int)(((long long)B * C + TS - 1) / TS) + K;
  err = persistent_grid(kern, 32 * tile_warps(TS), smem, blocks, max_tiles,
                        &grid, &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 32 * tile_warps(TS), smem, stream>>>(
      (const T*)keys, (const float*)ps, (const float*)pt,
      (const int32_t*)slots, (const int32_t*)offsets, (const float*)q,
      (const float*)g_out, (const float*)m, (const float*)l,
      (const float*)delta, (const float*)w1, (const float*)b1,
      (const float*)g, (const float*)bln, (const T*)w2f,
      (const float*)cbias, (const float*)att, (T*)dkeys, (float*)dq,
      (float*)dw1cat, (float*)dg, (float*)db, (float*)dcb, (float*)datt, C,
      O, dh, K, L.dc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dw2: about two waves of blocks over (slot chunk, class, dh tile,
  // column tile)
  const int ndc = (dh + kDw2T - 1) / kDw2T, noc = (O + kDw2T - 1) / kDw2T;
  const int ky = K * ndc * noc;
  int nchunk = (2 * sms + ky - 1) / ky;
  const long long max_chunk = ((long long)B * C + kDw2Slots - 1) / kDw2Slots;
  if (nchunk > max_chunk) nchunk = (int)max_chunk;
  if (nchunk < 1) nchunk = 1;
  const size_t smem2 =
      3 * (size_t)kDw2Slots * tile_stride(kDw2T, sizeof(T)) * sizeof(T) +
      3 * sizeof(float) * kDw2Slots;
  auto kern2 = pe_tiles_dw2_kernel<T>;
  if ((err = cudaFuncSetAttribute(
           kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2)) !=
      cudaSuccess)
    return (int)err;
  kern2<<<dim3(nchunk, ky), kDw2Threads, smem2, stream>>>(
      (const T*)dkeys, (const float*)ps, (const float*)pt,
      (const int32_t*)slots, (const int32_t*)offsets, (const float*)w1,
      (const float*)b1, (const float*)g, (const float*)bln, (float*)dw2, O,
      dh, ndc, noc);
  return (int)cudaGetLastError();
}

// Tiles of `ts` slots, 64 or 32 (ops/pe_attention_mixed.py:tile_slots: 64
// up to O, dh of 128, 32 past it, where shared memory is short).
template <typename T>
int launch_tiles_bwd(const void* keys, const void* ps, const void* pt,
                     const void* slots, const void* offsets, const void* q,
                     const void* g_out, const void* m, const void* l,
                     const void* delta, const void* w1, const void* b1,
                     const void* g, const void* bln, const void* w2f,
                     const void* cbias, const void* att, void* dkeys,
                     void* dq, void* dw1cat, void* dg, void* db, void* dcb,
                     void* datt, void* dw2, int B, int C, int O, int dh,
                     int K, int ts, cudaStream_t stream) {
  if (O < 1 || dh < 1 || K < 1 || K > 3 || (ts != 64 && ts != 32))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  auto launch = ts == 64 ? &launch_tiles<T, 64> : &launch_tiles<T, 32>;
  return launch(keys, ps, pt, slots, offsets, q, g_out, m, l, delta, w1, b1,
                g, bln, w2f, cbias, att, dkeys, dq, dw1cat, dg, db, dcb,
                datt, dw2, B, C, O, dh, K, stream);
}
}  // namespace
