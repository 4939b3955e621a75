// The chunk machinery of the per-link attention kernels (GATv2 without
// PE), for Hopper (sm_90a): what the forward (csrc/link_attention_fwd.cu)
// and the backward (csrc/link_attention_bwd.cu) share.
//
// A block takes whole links. For each link it lists the valid columns
// itself (ballots over the validity row, a prefix over the warps: no sort,
// no compaction launch, no host sync) and takes them in chunks of L.ts
// rows (128, or 64 where the wide tiles would not fit). Both directions
// run one prologue per chunk (chunk_xj):
//   (a)+(b) X = K W_r for the chunk's key rows K [ts, Dk], rows past the
//       count and columns past Dk zero, Dk and O padded to 16:
//       * bf16: K whole into shared memory by 16-byte cp.async copies
//         (element by element where a row is not 16-byte aligned), then
//         X on the tensor cores (mma.sync m16n8k16, f32 accumulate, the
//         ldmatrix helpers of csrc/pe_attention_tiles.cuh), W_r resident
//         for the launch where it fits, else staged in row chunks with X
//         passed through shared memory between them (product_kw);
//       * f32: exact FMA micro-tiles on the CUDA cores (no TF32), 8 rows x
//         8 columns a thread with its sums in registers, K and W_r
//         streamed through two shared-memory stages of 32 depth rows by
//         cp.async, the next stage's copy in flight while this one is
//         multiplied (product_stream). Each element's products are added
//         in depth order, as a plain f32 product adds them;
//   (c) xj = X + r_bias as X is stored, then each row's logit s = sum_o
//       att[o] lrelu(xj[o] q[b,o]), 8 rows a warp in a fixed order
//       (chunk_logits).
// So a slot's xj and s come out bit for bit the same in both directions,
// and alpha = exp(s - m) / max(l, 1e-16) is one expression
// (softmax_weight).
#pragma once

#include "pe_attention_tiles.cuh"

namespace {

constexpr int kTS = 128;                // rows of a chunk, at most
constexpr int kWarps = 8;               // of a main kernel's block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWarps = 16;           // of any block that lists links
// parts of a chunk's rows that the threads of one column walk side by side
// (where O <= kThreads / kParts), their sums then added in part order
constexpr int kParts = 2;
// the f32 stream: depth rows of a stage, and output columns of a pass
constexpr int kDS = 32;
constexpr int kCP = 128;

// per-row fields of a chunk, [kRows][ts] floats: the logit, then (the
// backward) alpha; g_out . xj, then dlogit; the forward's exp(s - m)
enum ChunkRow { kS, kG, kE, kRows };
// block scalars: the forward's running max and sum and the chunk's
// correction factor
enum Scalar { kM, kL, kCorr, kScalars };

// A main kernel's shared memory:
//   * W: bf16, W_r resident [pad16(Dk), ws] when dc covers it, else two
//     buffers of dc of its rows [dc, ws]; f32, the two stream stages (K
//     [ts, kDS + 4] and W_r [kDS, kCP + 4] each), which the backward's
//     dkeys product then takes as two buffers of W_r rows [dc, ws];
//   * K: bf16 only, the chunk's key rows [ts, ks], then the backward's
//     dxjc (f32's dxjc goes over X, element by element);
//   * X (then xj) f32 [ts, xs];
//   * three f32 vectors [O] (the forward's sum; the backward's dq, datt
//     and dr_bias) and the column walks' partial sums, [parts][3][O];
//   * the rows' fields and the scalars; the link's valid mask, its list
//     of valid columns and the warps' counts.
struct LinkSmem {
  int Dk, O, C, ts, dc, elem;
  __host__ __device__ bool stream() const { return elem == 4; }
  __host__ __device__ bool resident() const {
    return !stream() && dc >= pad16(Dk);
  }
  __host__ __device__ int ks() const { return tile_stride(imax(Dk, O), elem); }
  __host__ __device__ int ws() const { return tile_stride(O, elem); }
  __host__ __device__ int xs() const { return pad16(O) + 4; }
  __host__ __device__ size_t stage_floats() const {
    return (size_t)ts * (kDS + 4) + (size_t)kDS * (kCP + 4);
  }
  __host__ __device__ size_t w_bytes() const {
    if (stream()) return 2 * align16(stage_floats() * 4);
    return (resident() ? 1 : 2) * align16((size_t)dc * ws() * elem);
  }
  __host__ __device__ size_t k_bytes() const {
    return stream() ? 0 : align16((size_t)ts * ks() * elem);
  }
  __host__ __device__ size_t x_bytes() const {
    return align16((size_t)ts * xs() * 4);
  }
  __host__ __device__ size_t v_bytes() const {
    const int parts = kParts * O <= kThreads ? kParts : 1;
    return align16(3 * (1 + parts) * (size_t)pad16(O) * 4);
  }
  __host__ __device__ size_t r_bytes() const {
    return align16(4 * (size_t)(kRows * ts + kScalars));
  }
  __host__ __device__ size_t l_bytes() const {
    return align16(4 * (size_t)((C + 31) / 32 + C + kMaxWarps));
  }
  __host__ __device__ size_t fixed_bytes() const {
    return k_bytes() + x_bytes() + v_bytes() + r_bytes() + l_bytes();
  }
  __host__ __device__ size_t total() const {
    return w_bytes() + fixed_bytes();
  }
};

template <typename T>
struct LinkPtrs {
  T* wsm;           // W_r rows [dc, ws] (f32: the stream stages first)
  T* kt;            // key rows [ts, ks], then dxjc (bf16)
  float* x;         // X, xj [ts, xs] (f32: then dxjc)
  float* vec;       // [3][pad16(O)], then [parts][3][pad16(O)]
  float* rows;      // [kRows][ts]
  float* scal;      // [kScalars]
  unsigned* mask;   // [(C + 31) / 32] the link's validity bits
  int* list;        // [C] its valid columns, ascending
  int* wcnt;        // [kMaxWarps]
  __device__ LinkPtrs(unsigned char* raw, const LinkSmem& L) {
    wsm = reinterpret_cast<T*>(raw);
    raw += L.w_bytes();
    kt = reinterpret_cast<T*>(raw);
    raw += L.k_bytes();
    x = reinterpret_cast<float*>(raw);
    raw += L.x_bytes();
    vec = reinterpret_cast<float*>(raw);
    raw += L.v_bytes();
    rows = reinterpret_cast<float*>(raw);
    scal = rows + kRows * L.ts;
    raw += L.r_bytes();
    mask = reinterpret_cast<unsigned*>(raw);
    list = reinterpret_cast<int*>(mask + (L.C + 31) / 32);
    wcnt = list + L.C;
  }
};

// one 16-byte copy from device to shared memory, zero-filled past `bytes`
// (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Appends the valid columns of a validity row [C] to out[] in ascending
// order, as base + column, with the whole block (at most kMaxWarps warps);
// also keeps the row's bits in mask[] when it is given. Returns the count,
// the same in every thread. Begins and ends with a barrier.
__device__ int list_valid(const uint8_t* __restrict__ vrow, int C, int base,
                          int* out, unsigned* mask, int* wcnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int total = 0;
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool v = c < C && vrow[c];
    const unsigned bal = __ballot_sync(kFull, v);
    if (lane == 0) {
      wcnt[warp] = __popc(bal);
      if (mask && c0 + 32 * warp < C) mask[(c0 >> 5) + warp] = bal;
    }
    __syncthreads();
    int before = total, all = 0;
    for (int w = 0; w < nw; ++w) {
      const int k = wcnt[w];
      before += w < warp ? k : 0;
      all += k;
    }
    if (v) out[before + __popc(bal & ((1u << lane) - 1u))] = base + c;
    total += all;
    __syncthreads();
  }
  return total;
}

// Rows [0, rows) of a shared tile [rows, stride] in T from the row-major
// array src [*, len]: row r < n is src row row_of(r), columns [c0, c0 +
// cols) (cols a multiple of 16 / sizeof(T)); rows past n and columns past
// len are zeros. 16-byte cp.async copies when a row starts 16-byte aligned
// (len and c0 multiples of 16 / sizeof(T)), else element by element. The
// caller waits (cp_async_wait_all) and syncs.
template <typename T, typename RowOf>
__device__ __forceinline__ void gather_tile(T* dst, int stride,
                                            const T* __restrict__ src,
                                            int len, int c0, int cols,
                                            int rows, int n, RowOf row_of) {
  constexpr int vw = 16 / sizeof(T);
  const bool vec = len % vw == 0 && c0 % vw == 0;
  const int per = cols / vw;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = (i % per) * vw;
    T* d = dst + (size_t)r * stride + c;
    const T* s = r < n ? src + (size_t)row_of(r) * len + c0 + c : src;
    if (vec) {
      cp_async16(d, s, r < n && c0 + c < len ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < vw; ++e) {
        if (r < n && c0 + c + e < len)
          d[e] = s[e];
        else
          from_f32(0.f, d + e);
      }
    }
  }
}

// (b), bf16: X[:, 0 .. op) (+)= K[:, d0 .. d0 + nr) Wc for the staged W_r
// rows d0 .. d0 + nr (Wc [nr, ws]) over the chunk's rows in whole 16-row
// tiles below n (X's other rows are left as they are); K [ts, ks]; X f32
// [ts, xs], zeroed first when `first`, else added to, so a given chunking
// adds every element's products in one order; a warp per 16 x 64 output
// tile on mma.sync. With rbias (the last chunk), X is stored as xj = X +
// r_bias.
__device__ void product_kw(const __nv_bfloat16* K, int ks,
                           const __nv_bfloat16* W, int ws, float* X, int xs,
                           int op, int d0, int nr, int n, int ts, bool first,
                           const float* __restrict__ rbias, int O) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto fin = [&](float v, int c) {
    return rbias && c < O ? __fadd_rn(v, rbias[c]) : v;
  };
  const int nmt = ts / 16, items = nmt * ((op + 63) / 64);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  for (int it = warp; it < items; it += kWarps) {
    const int m0 = (it % nmt) * 16, n0 = (it / nmt) * 64;
    if (m0 >= n) continue;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + t2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v =
            (first || c >= op)
                ? make_float2(0.f, 0.f)
                : *reinterpret_cast<const float2*>(
                      X + (size_t)(m0 + g + 8 * hh) * xs + c);
        acc[j][2 * hh] = v.x;
        acc[j][2 * hh + 1] = v.y;
      }
    }
    // each depth step's fragments are all loaded before its products, so
    // the five ldmatrix latencies overlap
#pragma unroll 2
    for (int kk = 0; kk < nr; kk += 16) {
      uint32_t fa[4], b[4][4];
      ldsm_x4(fa, a_rows(K, ks, m0, d0 + kk, lane));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + 16 * j < op)
          ldsm_x4_t(b[j], b_rows(W, ws, n0 + 16 * j, kk, lane));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + 16 * j < op) {
          mma_bf16(acc[2 * j], fa, b[j][0], b[j][1]);
          mma_bf16(acc[2 * j + 1], fa, b[j][2], b[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + t2;
      if (c < op) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(X + (size_t)(m0 + g + 8 * hh) * xs + c) =
              make_float2(fin(acc[j][2 * hh], c),
                          fin(acc[j][2 * hh + 1], c + 1));
      }
    }
  }
}

// Runs fn(Wc, d0, nr) over W_r's rows [pad16(Dk), ws] in chunks of L.dc:
// once over the rows resident in wsm (bf16), or chunk by chunk through two
// buffers, each chunk's cp.async copy in flight while the previous chunk's
// product runs. Ends with a barrier.
template <typename T, typename Fn>
__device__ __forceinline__ void over_w_chunks(const T* __restrict__ w,
                                              const LinkSmem& L,
                                              const LinkPtrs<T>& p, Fn fn) {
  const int dkp = pad16(L.Dk), dc = L.dc, ws = L.ws();
  if (L.resident()) {
    fn(p.wsm, 0, dkp);
    __syncthreads();
    return;
  }
  T* const buf[2] = {p.wsm, p.wsm + (size_t)dc * ws};
  auto stage = [&](int i) {
    const int d0 = i * dc, nr = min(dc, dkp - d0);
    gather_tile(buf[i & 1], ws, w, L.O, 0, pad16(L.O), nr,
                min(nr, L.Dk - d0), [&](int r) { return d0 + r; });
  };
  const int nch = (dkp + dc - 1) / dc;
  __syncthreads();      // the previous readers of both buffers
  stage(0);
  for (int i = 0; i < nch; ++i) {
    cp_async_wait_all();
    __syncthreads();    // chunk i in place, chunk i - 1's readers done
    if (i + 1 < nch) stage(i + 1);
    fn(buf[i & 1], i * dc, min(dc, dkp - i * dc));
  }
  __syncthreads();
}

// (a)+(b), f32: X = K W_r + r_bias for the chunk's rows list[0 .. n) of
// the keys' rows from row0, in passes of kCP output columns: each pass
// streams K [ts, kDS] and W_r [kDS, kCP] stage by stage through the two
// stage buffers (cp.async; the next stage's copy in flight while this one
// is multiplied), a thread per 8 rows x 8 columns (c .. c+3 and c +
// ncols/2 .. +3, so a quarter warp's float4 reads of a W row are
// contiguous) with its 64 sums in registers: 16 float4 reads feed 256
// FMAs. Groups of 8 rows at or past n are skipped. Ends with a barrier.
__device__ void product_stream(const float* __restrict__ keys,
                               const float* __restrict__ w,
                               const float* __restrict__ rbias,
                               const LinkSmem& L, const LinkPtrs<float>& p,
                               const int* list, int n, size_t row0) {
  constexpr int kst = kDS + 4, wst = kCP + 4;
  const int Dk = L.Dk, O = L.O, op = pad16(O), xs = L.xs(), ts = L.ts;
  float* const kb[2] = {p.wsm, p.wsm + align16(L.stage_floats() * 4) / 4};
  const int nd = (Dk + kDS - 1) / kDS;
  for (int cp0 = 0; cp0 < op; cp0 += kCP) {
    const int ncols = min(kCP, op - cp0), ncg = ncols / 8, half = ncols / 2;
    const int items = (ts / 8) * ncg;
    const int it = threadIdx.x;
    const int r0 = (it / ncg) * 8, c = (it % ncg) * 4;
    const bool live = it < items && r0 < n;
    auto stage = [&](int s) {
      float* kd = kb[s & 1];
      gather_tile(kd, kst, keys, Dk, s * kDS, kDS, ts, n,
                  [&](int r) { return row0 + list[r]; });
      gather_tile(kd + ts * kst, wst, w, O, cp0, ncols, kDS,
                  min(kDS, Dk - s * kDS), [&](int r) { return s * kDS + r; });
    };
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    __syncthreads();    // the previous readers of both stages
    stage(0);
    for (int s = 0; s < nd; ++s) {
      cp_async_wait_all();
      __syncthreads();  // stage s in place, stage s - 1's readers done
      if (s + 1 < nd) stage(s + 1);
      if (!live) continue;
      const float* K = kb[s & 1];
      const float* W = K + ts * kst;
#pragma unroll 2
      for (int d = 0; d < kDS; d += 4) {
        float k[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              K + (r0 + i) * kst + d);
          k[i][0] = v.x; k[i][1] = v.y; k[i][2] = v.z; k[i][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* wr = W + (d + u) * wst + c;
          const float4 a = *reinterpret_cast<const float4*>(wr);
          const float4 b = *reinterpret_cast<const float4*>(wr + half);
          const float wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = __fmaf_rn(k[i][u], wv[j], acc[i][j]);
        }
      }
    }
    if (live) {
      auto fin = [&](float v, int col) {
        return col < O ? __fadd_rn(v, rbias[col]) : v;
      };
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* xr = p.x + (size_t)(r0 + i) * xs + cp0 + c;
        const int c0 = cp0 + c, c1 = c0 + half;
        *reinterpret_cast<float4*>(xr) =
            make_float4(fin(acc[i][0], c0), fin(acc[i][1], c0 + 1),
                        fin(acc[i][2], c0 + 2), fin(acc[i][3], c0 + 3));
        *reinterpret_cast<float4*>(xr + half) =
            make_float4(fin(acc[i][4], c1), fin(acc[i][5], c1 + 1),
                        fin(acc[i][6], c1 + 2), fin(acc[i][7], c1 + 3));
      }
    }
  }
  __syncthreads();
}

// One step of a transpose-reduce: the lanes that differ in bit S trade
// halves of p[0 .. 2S) and each keeps the sum of its half.
template <int S>
__device__ __forceinline__ void transpose_step(float* p, int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? p[i] : p[i + S];
    const float keep = upper ? p[i + S] : p[i];
    p[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, S));
  }
}

// Sums each of p[0..7] over the warp's lanes and returns the sum of
// p[lane & 7]; every index is known at compile time, so p stays in
// registers, and the order of the additions is fixed.
__device__ __forceinline__ float transpose_sum8(float* p, int lane) {
  transpose_step<4>(p, lane);
  transpose_step<2>(p, lane);
  transpose_step<1>(p, lane);
  const float v = __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], 8));
  return __fadd_rn(v, __shfl_xor_sync(kFull, v, 16));
}

// The logits of the chunk's rows r < n, xj X [ts, xs] of link row qb [O]:
// s = sum_o att[o] lrelu(X[r, o] qb[o]) into s_out[r], with kDot also gx =
// sum_o gb[o] X[r, o] into g_out_rows[r]. A warp takes 8 rows at once: each
// lane sums its columns (4 lane + 128 j .. +3 from float4 reads where O %
// 4 == 0, else lane + 32 j) of all 8, then one transpose-reduce gives each
// row's sum. The roundings are pinned: both directions get the same bits.
template <bool kDot>
__device__ __forceinline__ void chunk_logits(
    const float* X, int xs, const float* __restrict__ qb,
    const float* __restrict__ att, const float* __restrict__ gb, int O,
    int n, float* s_out, float* g_out_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r8 = 8 * warp; r8 < n; r8 += 8 * (blockDim.x >> 5)) {
    float p[8], gp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = gp[i] = 0.f;
    auto add = [&](int i, float x, float q, float a, float g) {
      const float pre = __fmul_rn(x, q);
      p[i] = __fmaf_rn(a, pre >= 0.f ? pre : __fmul_rn(0.2f, pre), p[i]);
      if (kDot) gp[i] = __fmaf_rn(g, x, gp[i]);
    };
    if (O % 4 == 0) {
      for (int o = 4 * lane; o < O; o += 128) {
        const float4 q4 = __ldg(reinterpret_cast<const float4*>(qb + o));
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(att + o));
        float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kDot) g4 = __ldg(reinterpret_cast<const float4*>(gb + o));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(X + (size_t)(r8 + i) * xs + o);
          add(i, x4.x, q4.x, a4.x, g4.x);
          add(i, x4.y, q4.y, a4.y, g4.y);
          add(i, x4.z, q4.z, a4.z, g4.z);
          add(i, x4.w, q4.w, a4.w, g4.w);
        }
      }
    } else {
      for (int o = lane; o < O; o += 32) {
        const float q = qb[o], a = att[o], g = kDot ? gb[o] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          add(i, X[(size_t)(r8 + i) * xs + o], q, a, g);
      }
    }
    const float s = transpose_sum8(p, lane);
    float gx = 0.f;
    if (kDot) gx = transpose_sum8(gp, lane);
    if (lane < 8 && r8 + lane < n) {
      s_out[r8 + lane] = s;
      if (kDot) g_out_rows[r8 + lane] = gx;
    }
  }
}

// The chunk prologue for the n <= ts valid columns list[0 .. n) of link
// b: (a), (b) and (c) above. On return (after a barrier) x holds each
// row's xj and rows[kS] its logit (with kDot, rows[kG] its g_out . xj).
template <typename T, bool kDot>
__device__ __forceinline__ void chunk_xj(
    const T* __restrict__ keys, const float* __restrict__ q,
    const float* __restrict__ g_out, const T* __restrict__ w,
    const float* __restrict__ rbias, const float* __restrict__ att,
    const LinkSmem& L, const LinkPtrs<T>& p, const int* list, int n, int b) {
  const int Dk = L.Dk, O = L.O, xs = L.xs(), ts = L.ts;
  const size_t row0 = (size_t)b * L.C;
  __syncthreads();      // the previous chunk's readers of kt, x and rows
  if constexpr (std::is_same<T, float>::value) {
    product_stream(keys, w, rbias, L, p, list, n, row0);
  } else {
    const int ks = L.ks(), ws = L.ws(), dkp = pad16(Dk), op = pad16(O);
    gather_tile(p.kt, ks, keys, Dk, 0, dkp, ts, n,
                [&](int r) { return row0 + list[r]; });
    cp_async_wait_all();
    __syncthreads();
    over_w_chunks(w, L, p, [&](const T* wc, int d0, int nr) {
      product_kw(p.kt, ks, wc, ws, p.x, xs, op, d0, nr, n, ts, d0 == 0,
                 d0 + nr >= dkp ? rbias : nullptr, O);
    });
  }
  chunk_logits<kDot>(p.x, xs, q + (size_t)b * O, att,
                     kDot ? g_out + (size_t)b * O : nullptr, O, n,
                     p.rows + kS * ts, p.rows + kG * ts);
  __syncthreads();
}

// Parts of a chunk's rows the threads of one column take side by side:
// kParts where every column then has its kParts threads, else 1 (and a
// thread walks several columns).
__device__ __forceinline__ int walk_parts(int O) {
  return kParts * O <= (int)blockDim.x ? kParts : 1;
}

// A main kernel's layout and its blocks per SM, the first of these that
// fits (chunks of 128 rows, else of 64):
//   * f32: the stream stages, with two blocks an SM, else one; the
//     backward's dkeys product then takes them as two buffers of the most
//     W_r rows (a multiple of 16) they hold;
//   * bf16: W_r resident for the launch with two blocks an SM; resident
//     with one block; two buffers of the most W_r rows (a multiple of 16)
//     with one.
// Returns false when none fits. The forward and the backward take the same
// layout (and so the same bits of xj).
inline bool link_layout(int Dk, int O, int C, int elem, LinkSmem* L,
                        int* blocks) {
  for (int ts = kTS; ts >= 64; ts /= 2) {
    *L = LinkSmem{Dk, O, C, ts, 0, elem};
    const size_t row = (size_t)L->ws() * elem, fixed = L->fixed_bytes();
    const int dkp = pad16(Dk);
    if (L->stream()) {
      L->dc = (int)(L->w_bytes() / (2 * row)) / 16 * 16;
      if (L->dc >= 16) {
        for (int blk = 2; blk >= 1; --blk) {
          if (block_smem_cap(blk) >= L->total()) {
            *blocks = blk;
            return true;
          }
        }
      }
      continue;
    }
    auto most = [&](int blk, int nbuf) {     // rows, a multiple of 16
      const size_t cap = block_smem_cap(blk);
      return cap < fixed ? 0 : (int)((cap - fixed) / (nbuf * row)) / 16 * 16;
    };
    auto take = [&](int dc, int blk) {
      L->dc = dc;
      *blocks = blk;
      return true;
    };
    if (most(2, 1) >= dkp) return take(dkp, 2);
    if (most(1, 1) >= dkp) return take(dkp, 1);
    if (most(1, 2) >= 16) return take(most(1, 2), 1);
  }
  return false;
}

// A main kernel's launch: its layout, shared memory and a persistent grid
// of at most one block per link.
struct LinkLaunch {
  LinkSmem L;
  size_t smem = 0;
  int blocks = 1, grid = 0, sms = 0;
};

template <typename Kern>
cudaError_t link_launch(Kern kern, int B, int C, int Dk, int O, int elem,
                        LinkLaunch* out) {
  if (Dk < 1 || O < 1 || C < 1 || (long long)B * C >= (1ll << 31) ||
      !link_layout(Dk, O, C, elem, &out->L, &out->blocks))
    return cudaErrorInvalidValue;
  out->smem = out->L.total();
  return persistent_grid(kern, kThreads, out->smem, out->blocks, B,
                         &out->grid, &out->sms);
}

}  // namespace
