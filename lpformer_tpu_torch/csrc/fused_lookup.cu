// Fused one-hot lookup, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/lookup.py: _kernel (:51)
// behind fused_lookup (:75, pallas_call :102), which the JAX package's
// ops/search.py:fused_row_member_values (:78) calls for every row
// membership / value lookup of context extraction when
// LPFORMER_FUSED_LOOKUP=1.
//
//   out[b, l, q] = sum_k (queries[b, q] == rows[b, k]) * lanes[b, l, k]
//
// in int32 with wraparound (sums run in uint32, whose overflow is defined;
// the pad queries of a row match all of its pad entries, and their sums
// may wrap). Row ids are unique per row, so a real query matches at most
// one entry and its sum is that entry's lane values, bit for bit (f32
// values ride as their bit patterns).
//
// What bounds it on an H100: the compares, B*Q*K of them, a few ns of
// work per (b, q) against the bytes of rows, queries, lanes and out read
// and written once (a few MB at the context-extraction shapes). Design:
// one block per batch row; its K row ids and L x K lane values are staged
// in shared memory (in chunks of 1024 entries), and each thread takes one
// query and walks the row: every thread reads the same entry at once, a
// broadcast, and a match adds the entry's lanes into registers. The TPU
// kernel builds the [bb, Q, kc] equality tile in VMEM instead; on the card
// a thread per query needs no equality tensor at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries in flight per block
constexpr int kChunk = 1024;    // row entries staged at once
constexpr int kLanes = 4;       // value lanes summed per pass over the row

__global__ void __launch_bounds__(kThreads)
fused_lookup_kernel(const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ queries,
                    const int32_t* __restrict__ lanes,
                    int32_t* __restrict__ out, int B, int K, int Q, int L) {
  __shared__ int32_t rs[kChunk];
  __shared__ uint32_t ls[kLanes][kChunk];
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int l0 = 0; l0 < L; l0 += kLanes) {
      const int nl = min(kLanes, L - l0);
      for (int k0 = 0; k0 < K; k0 += kChunk) {
        const int nk = min(kChunk, K - k0);
        __syncthreads();  // the previous chunk's reads are done
        for (int i = threadIdx.x; i < nk; i += kThreads) {
          rs[i] = rows[(size_t)b * K + k0 + i];
          for (int l = 0; l < nl; ++l)
            ls[l][i] = (uint32_t)lanes[((size_t)b * L + l0 + l) * K + k0 + i];
        }
        __syncthreads();
        for (int qi = threadIdx.x; qi < Q; qi += kThreads) {
          const int32_t qv = queries[(size_t)b * Q + qi];
          uint32_t acc[kLanes] = {0u, 0u, 0u, 0u};
          for (int k = 0; k < nk; ++k) {
            if (rs[k] == qv) {
#pragma unroll
              for (int l = 0; l < kLanes; ++l)
                if (l < nl) acc[l] += ls[l][k];
            }
          }
          for (int l = 0; l < nl; ++l) {
            int32_t* o = out + ((size_t)b * L + l0 + l) * Q + qi;
            // a later chunk adds to the earlier chunks' sum (this thread
            // wrote it)
            *o = (int32_t)(acc[l] + (k0 ? (uint32_t)*o : 0u));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// rows [B, K], queries [B, Q], lanes [B, L, K] and out [B, L, Q], all
// int32, contiguous.
int fused_lookup(const void* rows, const void* queries, const void* lanes,
                 void* out, int B, int K, int Q, int L, void* stream) {
  if (B < 0 || K < 1 || Q < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  fused_lookup_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)queries, (const int32_t*)lanes,
      (int32_t*)out, B, K, Q, L);
  return (int)cudaGetLastError();
}

const char* fused_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
