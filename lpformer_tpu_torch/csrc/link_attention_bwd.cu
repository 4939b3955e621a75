// Fused per-link GATv2 attention without PE, backward pass, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/attention.py:
// _bwd_kernel (:137) behind _bwd_call (:225, pallas_call :230), reached
// from the custom VJP _fused_bwd (:302), heads == 1.
//
// Recomputes each valid slot's xj = keys @ W_r + r_bias from the forward's
// saved m, l (as csrc/link_attention_fwd.cu computes it), then, with g_out
// [B, O] and delta[b] = g_out[b] . (out[b] - bias):
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
// 144 us at 3.35 TB/s, against three Dk*O products a valid slot (84 us on
// the bf16 tensor cores; in f32 1.2 ms on the CUDA cores). Design, in two
// launches, for any Dk and O:
//   * main kernel, one warp per link as in the forward: valid slots taken
//     up to 4 at a time recompute xj with each W_r read feeding the 4
//     slots; W_r's rows sit in shared memory as far as it holds them, as
//     in the forward; the warp's slice of shared memory holds the group's
//     key rows, their xj (then dxjc), the link's dq and the warp's datt and
//     dr_bias (each lane its own columns), flushed per block with
//     shared-memory atomics and one global atomicAdd per element and
//     block. dkeys = dxjc W_r^T for the group's slots at once reads W_r
//     rows whole (coalesced), each row feeding the 4 slots: each lane sums
//     its columns' share of 8 rows, and a transpose-reduce per slot leaves
//     row d0 + lane's sum with lane `lane` < 8, which writes it. Dead
//     slots get their zero row and nothing else. dxjc of the valid slots
//     goes to a [B, C, O] scratch in the keys' type;
//   * dW kernel: dW [Dk, O] sums over every valid slot of the batch while
//     blocks run in parallel (the TPU carries it in scratch through its
//     sequential grid), so a second launch reduces it by (link chunk,
//     128 x 128 tile): each round, each warp stages one valid slot's key
//     row and dxjc (read back from the scratch) in shared memory, and
//     every thread adds the eight outer-product terms of its column and
//     64 rows in registers; blocks flush with one global atomicAdd per
//     element.
// Every sum across warps and blocks goes through f32 atomics, so the order
// of the additions changes from run to run.

#include "link_attention_common.cuh"

namespace {

constexpr int kWarps = 16;              // links in flight per block (at most)
constexpr int kThreads = kWarps * 32;
constexpr int kBlocks = 1;              // resident blocks per SM
constexpr int kDwWarps = 8;             // dW kernel
constexpr int kDwThreads = kDwWarps * 32;
constexpr int kDwTile = 128;            // rows and columns per dW block

// floats of a warp's slice of shared memory: ks [kSlots][Dk], xs
// [kSlots][O], dqs, dts, drs [O], each row 16-byte aligned
__host__ __device__ constexpr size_t bwd_slice(int Dk, int O) {
  return (size_t)kSlots * (pad4(Dk) + pad4(O)) + 3 * (size_t)pad4(O);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
link_attention_bwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, const float* __restrict__ g_out,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, const T* __restrict__ w,
    const float* __restrict__ rbias, const float* __restrict__ att,
    T* __restrict__ dkeys, T* __restrict__ dxc, float* __restrict__ dq,
    float* __restrict__ drb, float* __restrict__ datt,
    int B, int C, int Dk, int O, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // W_r's leading `staged` rows [staged, O], the block's sums, then the
  // warps' slices
  T* ws = reinterpret_cast<T*>(smem_raw);
  float* acc_rb = reinterpret_cast<float*>(
      smem_raw + staged_bytes(1, staged, O, sizeof(T)));    // [O]
  float* acc_att = acc_rb + pad4(O);                        // [O]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dkp = pad4(Dk), op = pad4(O);
  // the warp's slice: ks [kSlots][Dk] (the group's key rows, read by
  // every lane), xs [kSlots][O] (their xj, then dxjc), dqs [O] (the link's
  // dq), dts [O] and drs [O] (the warp's datt and dr_bias); own columns
  float* ks = acc_att + op + (size_t)warp * bwd_slice(Dk, O);
  float* xs = ks + kSlots * dkp;
  float* dqs = xs + kSlots * op;
  float* dts = dqs + op;
  float* drs = dts + op;
  const bool vec = (O & 3) == 0;
  const float zero4[4] = {0.f, 0.f, 0.f, 0.f};

  for (int i = threadIdx.x; i < 2 * op; i += blockDim.x) acc_rb[i] = 0.f;
  for (int i = lane; i < kSlots * dkp; i += 32) ks[i] = 0.f;
  for (int o = lane; o < O; o += 32) dts[o] = drs[o] = 0.f;
  stage_rows(w, ws, 1, Dk, staged, O);
  __syncthreads();
  const SplitRows<T> wr = {ws, w, staged};

  for (int b = next_link(lane, B); b < B; b = next_link(lane, B)) {
    for (int o = 4 * lane; o < O; o += kGroup)
      sts4(dqs + o, min(4, O - o), vec, zero4);
    const float m = m_in[b], lc = fmaxf(l_in[b], 1e-16f), dl = delta_in[b];

    for (int c0 = 0; c0 < C; c0 += 32) {
      const int cl = c0 + lane;
      const bool inr = cl < C;
      const bool v = inr && valid[(size_t)b * C + cl];
      unsigned dead = __ballot_sync(kFull, inr && !v);
      while (dead) {       // dead slots: zero rows, nothing else
        const int bit = __ffs(dead) - 1;
        dead &= dead - 1;
        T* row = dkeys + ((size_t)b * C + c0 + bit) * Dk;
        for (int d = 4 * lane; d < Dk; d += kGroup)
          storen(row + d, min(4, Dk - d), (Dk & 3) == 0, zero4);
      }
      unsigned live = __ballot_sync(kFull, v);
      while (live) {
        int slot[kSlots];
        const int ns = take_slots(live, c0, slot);
        __syncwarp();  // the previous group's reads of ks and xs are done
        stage_keys(keys, (size_t)b * C, slot, ns, Dk, dkp, lane, ks);
        __syncwarp();

        // forward recompute: xj, logits, g_out . xj
        float part[kSlots] = {0.f, 0.f, 0.f, 0.f};
        float gpart[kSlots] = {0.f, 0.f, 0.f, 0.f};
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float x[kSlots][4] = {};
          group_product(wr, ks, dkp, Dk, O, o, n, vec, x);
          float rb[4], qv[4], av[4], gv[4];
          loadn(rbias + o, n, vec, rb);
          loadn(q + (size_t)b * O + o, n, vec, qv);
          loadn(att + o, n, vec, av);
          loadn(g_out + (size_t)b * O + o, n, vec, gv);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              x[s][i] += rb[i];
              const float z = x[s][i] * qv[i];
              part[s] += av[i] * (z >= 0.f ? z : 0.2f * z);   // 0 past O
              gpart[s] += gv[i] * x[s][i];
            }
            sts4(xs + s * op + o, n, vec, x[s]);
          }
        }

        // attention backward of each slot: dxj, dq, datt, dr_bias; xs
        // becomes dxjc
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s >= ns) break;
          const float sv = warp_sum(part[s]);
          const float galpha = warp_sum(gpart[s]);
          const float alpha = expf(sv - m) / lc;
          const float dlog = alpha * (galpha - dl);
          const size_t bc = (size_t)b * C + slot[s];
          float* xrow = xs + s * op;
          for (int o = 4 * lane; o < O; o += kGroup) {
            const int n = min(4, O - o);
            float qv[4], av[4], gv[4], x[4], dt[4], dqv[4], dr[4], dx[4];
            loadn(q + (size_t)b * O + o, n, vec, qv);
            loadn(att + o, n, vec, av);
            loadn(g_out + (size_t)b * O + o, n, vec, gv);
            lds4(xrow + o, n, vec, x);
            lds4(dts + o, n, vec, dt);
            lds4(dqs + o, n, vec, dqv);
            lds4(drs + o, n, vec, dr);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pre = x[i] * qv[i];
              const float dpre = dlog * av[i] * (pre >= 0.f ? 1.f : 0.2f);
              const float dxj = alpha * gv[i] + dpre * qv[i];
              dx[i] = round_to(dxj, T());
              dt[i] += dlog * (pre >= 0.f ? pre : 0.2f * pre);
              dqv[i] += dpre * x[i];
              dr[i] += dxj;
            }
            sts4(dts + o, n, vec, dt);
            sts4(dqs + o, n, vec, dqv);
            sts4(drs + o, n, vec, dr);
            sts4(xrow + o, n, vec, dx);
            storen(dxc + bc * O + o, n, vec, dx);
          }
        }

        // dkeys = dxjc W_r^T for the group's slots at once, so each W_r
        // row read feeds them all: per 8 rows, each lane's share over its
        // columns, then a transpose-reduce per slot
        for (int d0 = 0; d0 < Dk; d0 += 8) {
          float p[kSlots][8];
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
#pragma unroll
            for (int r = 0; r < 8; ++r) p[s][r] = 0.f;
          for (int o = 4 * lane; o < O; o += kGroup) {
            const int n = min(4, O - o);
            float dx[kSlots][4];
#pragma unroll
            for (int s = 0; s < kSlots; ++s) lds4(xs + s * op + o, n, vec,
                                                  dx[s]);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (d0 + r < Dk) {
                float wv[4];
                row4(wr, d0 + r, O, o, n, vec, wv);
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                  p[s][r] += wv[0] * dx[s][0] + wv[1] * dx[s][1] +
                             wv[2] * dx[s][2] + wv[3] * dx[s][3];
              }
            }
          }
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const float dk = transpose_reduce8(p[s], lane);
            if (s < ns && lane < 8 && d0 + lane < Dk)
              from_f32(dk, dkeys + ((size_t)b * C + slot[s]) * Dk + d0 +
                               lane);
          }
        }
      }
    }
    for (int o = 4 * lane; o < O; o += kGroup) {
      const int n = min(4, O - o);
      float r[4];
      lds4(dqs + o, n, vec, r);
      storen(dq + (size_t)b * O + o, n, vec, r);
    }
  }

  __syncwarp();  // dts and drs hold every lane's columns
  for (int o = lane; o < O; o += 32) {
    atomicAdd(acc_rb + o, drs[o]);
    atomicAdd(acc_att + o, dts[o]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < O; i += blockDim.x) {
    atomicAdd(drb + i, acc_rb[i]);
    atomicAdd(datt + i, acc_att[i]);
  }
}

// dW[d0 .. d0+127][o0 .. o0+127] = sum over valid slots of keys[d]^T
// dxjc[o], for block (chunk, dc * noc + oc): rows d0 = dc * 128 onwards,
// columns o0 = oc * 128 onwards. In each round every warp takes the next
// valid slot of its links (links b0, b0 + stride, ...) and stages the
// slot's key row over the block's rows and its dxjc over the block's
// columns in shared memory; then every thread adds the round's eight
// outer-product terms of its column and its 64 rows in registers.
template <typename T>
__global__ void __launch_bounds__(kDwThreads, 2)
link_attention_dw_kernel(const T* __restrict__ keys,
                         const T* __restrict__ dxc,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ dw, int B, int C, int Dk, int O,
                         int noc) {
  __shared__ __align__(16) float kb[kDwWarps][kDwTile];
  __shared__ float db[kDwWarps][kDwTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = (blockIdx.y / noc) * kDwTile, nd = min(kDwTile, Dk - d0);
  const int o0 = (blockIdx.y % noc) * kDwTile, no = min(kDwTile, O - o0);
  // this thread's column of the tile and its half of the tile's rows
  const int col = threadIdx.x & (kDwTile - 1);
  const int half = threadIdx.x / kDwTile;
  const int stride = gridDim.x * kDwWarps;
  int b = blockIdx.x * kDwWarps + warp, c0 = -32;
  unsigned live = 0;

  float acc[kDwTile / 2];
#pragma unroll
  for (int i = 0; i < kDwTile / 2; ++i) acc[i] = 0.f;
  bool more = true;

  while (__syncthreads_or(more)) {
    while (more && !live) {    // the warp's next chunk with a valid slot
      c0 += 32;
      if (c0 >= C) {
        b += stride;
        c0 = 0;
      }
      if (b >= B) {
        more = false;
        break;
      }
      live = __ballot_sync(kFull, c0 + lane < C &&
                                      valid[(size_t)b * C + c0 + lane]);
    }
    if (more) {
      const int bit = __ffs(live) - 1;
      live &= live - 1;
      const size_t bc = (size_t)b * C + c0 + bit;
      for (int d = lane; d < kDwTile; d += 32) {
        kb[warp][d] = d < nd ? to_f32(keys[bc * Dk + d0 + d]) : 0.f;
        db[warp][d] = d < no ? to_f32(dxc[bc * O + o0 + d]) : 0.f;
      }
    } else {        // no slot left: a zero term (no stale values)
      for (int d = lane; d < kDwTile; d += 32) kb[warp][d] = db[warp][d] = 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int w = 0; w < kDwWarps; ++w) {
      const float dx = db[w][col];
      const float* h = kb[w] + half * (kDwTile / 2);
#pragma unroll
      for (int i = 0; i < kDwTile / 2; i += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(h + i);
        acc[i] += h4.x * dx;
        acc[i + 1] += h4.y * dx;
        acc[i + 2] += h4.z * dx;
        acc[i + 3] += h4.w * dx;
      }
    }
  }

  if (col < no) {
#pragma unroll
    for (int i = 0; i < kDwTile / 2; ++i) {
      const int d = half * (kDwTile / 2) + i;
      if (d < nd) atomicAdd(dw + (size_t)(d0 + d) * O + o0 + col, acc[i]);
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
  if (Dk < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t fixed = sizeof(float) * 2 * (size_t)pad4(O);
  const size_t per_warp = sizeof(float) * bwd_slice(Dk, O);
  const size_t cap = block_smem_cap(kBlocks);
  const int warps = warps_that_fit(kWarps, fixed, per_warp, cap);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int staged =
      rows_that_fit(1, Dk, O, sizeof(T), fixed + warps * per_warp, cap);
  const size_t smem =
      staged_bytes(1, staged, O, sizeof(T)) + fixed + warps * per_warp;
  auto kern = link_attention_bwd_kernel<T>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, warps * 32, smem, kBlocks,
                                    (B + warps - 1) / warps, &grid, &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)keys, (const float*)q, (const uint8_t*)valid,
      (const float*)g_out, (const float*)m, (const float*)l,
      (const float*)delta, (const T*)w, (const float*)rbias,
      (const float*)att, (T*)dkeys, (T*)dxc, (float*)dq, (float*)drb,
      (float*)datt, B, C, Dk, O, staged);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dW: about two waves of blocks over (link chunk, row tile, column tile)
  const int ndc = (Dk + kDwTile - 1) / kDwTile;
  const int noc = (O + kDwTile - 1) / kDwTile;
  const int ky = ndc * noc;
  int nchunk = (2 * sms + ky - 1) / ky;
  const int max_chunk = (B + kDwWarps - 1) / kDwWarps;
  if (nchunk > max_chunk) nchunk = max_chunk;
  if (nchunk < 1) nchunk = 1;
  link_attention_dw_kernel<T><<<dim3(nchunk, ky), kDwThreads, 0, stream>>>(
      (const T*)keys, (const T*)dxc, (const uint8_t*)valid, (float*)dw, B, C,
      Dk, O, noc);
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
