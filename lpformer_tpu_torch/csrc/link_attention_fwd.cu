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
// in bf16, 64 us at 3.35 TB/s, against 2 Dk O flops a slot, 28 us on the
// bf16 tensor cores; in f32 the product (410 us at 67 TFLOP/s on the CUDA
// cores) bounds it.
// Design, one launch, in one pass: a persistent block takes whole links;
// per link it lists the valid columns and runs the chunk prologue of
// csrc/link_attention_tiles.cuh on chunks of up to 128 of them (X = K W_r
// on mma.sync in bf16, with K gathered by cp.async and W_r resident where
// it fits; in f32 as exact FMA micro-tiles with K and W_r streamed through
// two cp.async stages; xj and the logits), then carries the online softmax
// across the link's chunks as the TPU kernel does across its C tiles:
// warp 0 takes the chunk's max, the correction and each row's exp(s - m),
// and two threads per column (each half of the rows) fold the rows into
// the link's sum in shared memory, the halves added in order. out, m and
// l are written once per link: no [B, C] scratch, no atomics, and the
// result is the same from run to run.

#include "link_attention_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
link_attention_fwd_kernel(
    const T* __restrict__ keys, const float* __restrict__ q,
    const uint8_t* __restrict__ valid, const T* __restrict__ w,
    const float* __restrict__ rbias, const float* __restrict__ att,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int B, int C,
    int Dk, int O, int ts, int dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LinkSmem L{Dk, O, C, ts, dc, (int)sizeof(T)};
  const LinkPtrs<T> p(smem_raw, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xs = L.xs();
  const int op = pad16(O);
  float* acc = p.vec;           // [O] the link's weighted sum
  float* part = p.vec + 3 * op; // [kParts][O] a chunk's parts of it
  float* e = p.rows + kE * ts;
  if (L.resident()) stage_w(w, p.wsm, 0, pad16(Dk), Dk, O, L.ws());

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int nv = list_valid(valid + (size_t)b * C, C, 0, p.list, nullptr,
                              p.wcnt);
    for (int o = threadIdx.x; o < O; o += blockDim.x) acc[o] = 0.f;
    if (threadIdx.x == 0) {
      p.scal[kM] = kNeg / 2;
      p.scal[kL] = 0.f;
    }
    for (int r0 = 0; r0 < nv; r0 += ts) {
      const int n = min(ts, nv - r0);
      chunk_xj<T, false>(keys, q, nullptr, w, rbias, att, L, p, p.list + r0,
                         n, b);
      // online softmax: the chunk's max, the correction, each row's weight
      if (warp == 0) {
        const float* s = p.rows + kS * ts;
        float mc = kNeg;
        for (int r = lane; r < n; r += 32) mc = fmaxf(mc, s[r]);
        const float m0 = p.scal[kM];
        const float m1 = fmaxf(m0, warp_max(mc));
        float es = 0.f;
        for (int r = lane; r < n; r += 32) {
          const float v = expf(s[r] - m1);
          e[r] = v;
          es += v;
        }
        es = warp_sum(es);
        if (lane == 0) {
          const float corr = expf(m0 - m1);
          p.scal[kCorr] = corr;
          p.scal[kL] = p.scal[kL] * corr + es;
          p.scal[kM] = m1;
        }
      }
      __syncthreads();
      // each part of the rows sums its share of every column, then the
      // parts are added in order
      const int parts = walk_parts(O);
      for (int t = threadIdx.x; t < parts * O; t += blockDim.x) {
        const int o = t % O;
        int ra, rb;
        row_split(n, parts, t / O, ra, rb);
        float a = 0.f;
#pragma unroll 4
        for (int r = ra; r < rb; ++r)
          a = __fmaf_rn(e[r], p.x[(size_t)r * xs + o], a);
        part[(t / O) * op + o] = a;
      }
      __syncthreads();
      const float corr = p.scal[kCorr];
      for (int o = threadIdx.x; o < O; o += blockDim.x) {
        float a = part[o];
        for (int k = 1; k < parts; ++k) a = __fadd_rn(a, part[k * op + o]);
        acc[o] = __fmaf_rn(acc[o], corr, a);
      }
    }
    __syncthreads();
    const float l = p.scal[kL];
    const float denom = fmaxf(l, 1e-16f);
    for (int o = threadIdx.x; o < O; o += blockDim.x)
      out[(size_t)b * O + o] = acc[o] / denom + bias[o];
    if (threadIdx.x == 0) {
      m_out[b] = p.scal[kM];
      l_out[b] = l;
    }
  }
}

template <typename T>
int launch(const void* keys, const void* q, const void* valid,
           const void* w, const void* rbias, const void* att,
           const void* bias, void* out, void* m_out, void* l_out, int B,
           int C, int Dk, int O, cudaStream_t stream) {
  if (B == 0) return 0;
  auto kern = link_attention_fwd_kernel<T>;
  LinkLaunch t;
  cudaError_t err = link_launch(kern, B, C, Dk, O, (int)sizeof(T), &t);
  if (err != cudaSuccess) return (int)err;
  kern<<<t.grid, kThreads, t.smem, stream>>>(
      (const T*)keys, (const float*)q, (const uint8_t*)valid, (const T*)w,
      (const float*)rbias, (const float*)att, (const float*)bias,
      (float*)out, (float*)m_out, (float*)l_out, B, C, Dk, O, t.L.ts,
      t.L.dc);
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
