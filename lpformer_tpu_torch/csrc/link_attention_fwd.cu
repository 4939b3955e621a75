// Fused per-link GATv2 attention without PE, forward pass, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/attention.py:
// _fwd_kernel (:42) behind _fwd_call (:89, pallas_call :94), reached from
// the public fused_link_attention (:325), heads == 1.
//
// For each link b and each VALID slot c:
//   xj     = keys[b,c] @ W_r + r_bias                (f32 accumulation)
//   s      = sum_o att[o] * leaky_relu_0.2(xj[o] * q[b,o])
//   out[b] = sum_c softmax_c(s) xj / max(l, 1e-16) + bias   (online softmax)
// and the softmax statistics m[b] (running max, -5e29 for a link with no
// valid slot) and l[b] (sum of exp(s - m)), which the backward takes.
//
// What bounds it on an H100: at the bench's A/B shape (B = 4096, C = 128,
// Dk = 256, O = 128, 80% of the slots valid) the valid key rows are 215 MB
// in bf16, 67 us at 3.35 TB/s, against 2*Dk*O flops a slot, 28 us on the
// bf16 tensor cores; in f32 the products (410 us at 67 TFLOP/s) bound it.
// What the design does about it:
//   * one warp per link, for any Dk and O: lanes own 4 output columns per
//     group of 128; no block barriers, only warp shuffles. A link's
//     running sums over O sit in the warp's slice of shared memory;
//   * valid slots are found 32 at a time with a ballot over the validity
//     row, and taken up to 4 at a time: the warp stages their key rows in
//     its slice of shared memory (as f32, one coalesced read each; dead
//     slots' rows are never read), then each lane forms the 4 slots' xj
//     over its columns, so each W_r element read feeds the 4 slots; W_r's
//     rows sit in shared memory as far as it holds them (all of them in
//     bf16 at the A/B's shape), the rest are read through the read-only
//     path (csrc/link_attention_common.cuh);
//   * the 4 logits go through the online softmax one after another, as
//     the TPU kernel's per-tile update does for a tile.
// The products run on the CUDA cores in f32; batching slots through wgmma
// is later work.

#include "link_attention_common.cuh"

namespace {

constexpr int kWarps = 16;              // links in flight per block (at most)
constexpr int kThreads = kWarps * 32;
constexpr int kBlocks = 1;              // resident blocks per SM

// floats of a warp's slice of shared memory: ks [kSlots][Dk], xs
// [kSlots][O], acc [O], each row 16-byte aligned
__host__ __device__ constexpr size_t fwd_slice(int Dk, int O) {
  return (size_t)kSlots * (pad4(Dk) + pad4(O)) + pad4(O);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
link_attention_fwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, const T* __restrict__ w,
    const float* __restrict__ rbias, const float* __restrict__ att,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int B, int C, int Dk, int O, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // W_r's leading `staged` rows [staged, O], then the warps' slices
  T* ws = reinterpret_cast<T*>(smem_raw);
  float* smem = reinterpret_cast<float*>(
      smem_raw + staged_bytes(1, staged, O, sizeof(T)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dkp = pad4(Dk), op = pad4(O);
  // the warp's slice: ks [kSlots][Dk] (the group's key rows, read by every
  // lane), xs [kSlots][O] (their xj), acc [O] (the link's weighted sum);
  // xs and acc own columns
  float* ks = smem + (size_t)warp * fwd_slice(Dk, O);
  float* xs = ks + kSlots * dkp;
  float* acc = xs + kSlots * op;
  const bool vec = (O & 3) == 0;
  const float zero4[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = lane; i < kSlots * dkp; i += 32) ks[i] = 0.f;
  stage_rows(w, ws, 1, Dk, staged, O);
  __syncthreads();
  const SplitRows<T> wr = {ws, w, staged};

  for (int b = next_link(lane, B); b < B; b = next_link(lane, B)) {
    for (int o = 4 * lane; o < O; o += kGroup)
      sts4(acc + o, min(4, O - o), vec, zero4);
    float m = kNeg / 2, l = 0.f;

    for (int c0 = 0; c0 < C; c0 += 32) {
      const int cl = c0 + lane;
      unsigned live =
          __ballot_sync(kFull, cl < C && valid[(size_t)b * C + cl]);
      while (live) {
        int slot[kSlots];
        const int ns = take_slots(live, c0, slot);
        __syncwarp();  // the previous group's reads of ks are done
        stage_keys(keys, (size_t)b * C, slot, ns, Dk, dkp, lane, ks);
        __syncwarp();

        float part[kSlots] = {0.f, 0.f, 0.f, 0.f};
        for (int o = 4 * lane; o < O; o += kGroup) {
          const int n = min(4, O - o);
          float x[kSlots][4] = {};
          group_product(wr, ks, dkp, Dk, O, o, n, vec, x);
          float rb[4], qv[4], av[4];
          loadn(rbias + o, n, vec, rb);
          loadn(q + (size_t)b * O + o, n, vec, qv);
          loadn(att + o, n, vec, av);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              x[s][i] += rb[i];
              const float z = x[s][i] * qv[i];
              part[s] += av[i] * (z >= 0.f ? z : 0.2f * z);   // 0 past O
            }
            sts4(xs + s * op + o, n, vec, x[s]);
          }
        }
        // online softmax, one slot after another
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s >= ns) break;
          const float sv = warp_sum(part[s]);
          const float m1 = fmaxf(m, sv);
          const float corr = expf(m - m1), e = expf(sv - m1);
          l = l * corr + e;
          for (int o = 4 * lane; o < O; o += kGroup) {
            const int n = min(4, O - o);
            float a[4], x[4];
            lds4(acc + o, n, vec, a);
            lds4(xs + s * op + o, n, vec, x);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = a[i] * corr + e * x[i];
            sts4(acc + o, n, vec, a);
          }
          m = m1;
        }
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

template <typename T>
int launch(const void* keys, const void* q, const void* valid,
           const void* w, const void* rbias, const void* att,
           const void* bias, void* out, void* m_out, void* l_out, int B,
           int C, int Dk, int O, cudaStream_t stream) {
  if (Dk < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t per_warp = sizeof(float) * fwd_slice(Dk, O);
  const size_t cap = block_smem_cap(kBlocks);
  const int warps = warps_that_fit(kWarps, 0, per_warp, cap);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int staged = rows_that_fit(1, Dk, O, sizeof(T), warps * per_warp, cap);
  const size_t smem = staged_bytes(1, staged, O, sizeof(T)) + warps * per_warp;
  auto kern = link_attention_fwd_kernel<T>;
  int grid = 0, sms = 0;
  cudaError_t err = persistent_grid(kern, warps * 32, smem, kBlocks,
                                    (B + warps - 1) / warps, &grid, &sms);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)keys, (const float*)q, (const uint8_t*)valid, (const T*)w,
      (const float*)rbias, (const float*)att, (const float*)bias,
      (float*)out, (float*)m_out, (float*)l_out, B, C, Dk, O, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// bf16 != 0: keys and w are bfloat16, else float32. valid is uint8/bool,
// everything else float32: q [B, O], r_bias, att, bias [O]; out [B, O],
// m, l [B].
int link_attention_fwd(const void* keys, const void* q, const void* valid,
                       const void* w, const void* rbias, const void* att,
                       const void* bias, void* out, void* m_out, void* l_out,
                       int B, int C, int Dk, int O, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(keys, q, valid, w, rbias, att, bias, out,
                                 m_out, l_out, B, C, Dk, O, s);
  return launch<float>(keys, q, valid, w, rbias, att, bias, out, m_out, l_out,
                       B, C, Dk, O, s);
}

const char* link_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
