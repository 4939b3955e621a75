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
// in int32 with wraparound (sums run in uint32, whose overflow is defined
// and whose order does not matter, so every order gives the same bits).
// Rows need not be sorted and may repeat an id (the pads do); any int32 is
// a legal id.
//
// What bounds it on an H100: bytes. The TPU kernel compares every query
// with every entry (B*Q*K compares, 268M at the main shape B 4096, K = Q =
// 256): far more time on the card than reading rows, queries and lanes
// and writing out once. Design: each batch row hashes its queries into an
// open-addressing table in shared memory and streams its entries past it,
// O(K + Q) work a row:
//   * a slot's key is a 64-bit word holding the id zero-extended, so the
//     empty word (all ones) is no int32 id; a query claims its slot with a
//     64-bit atomicCAS (a repeated query finds the same slot) and zeroes
//     the slot's lane sums;
//   * capacity H = 2^log2h >= 2 * chunk, a multiplicative hash (the ids are
//     clustered node numbers), linear probing to the key or an empty slot;
//   * each entry probes the table, and an entry whose id is a query adds
//     its lanes into that slot (uint32 atomicAdd in shared memory, so
//     repeated entries sum); then each query reads its slot's sums into
//     out;
//   * more than `chunk` queries go chunk by chunk (each chunk streams the
//     whole row), and lanes `lanes_per_pass` at a time, so neither Q, K nor
//     L is capped;
//   * `rows_per_block` rows share a block of 256 threads, a group of
//     256 / rows_per_block threads each, about 8 entries or queries a
//     thread; rows, lanes, queries and out move in 16-byte words where K
//     (or Q) is a multiple of 4 and the pointers are aligned, and each
//     thread's first words of entries, lanes and queries are loaded before
//     the table is built, so no load waits on a probe.
// The plan (chunk, log2h, lanes_per_pass, rows_per_block) comes from the
// wrapper (ops/lookup.py: hash_plan), whose CPU tests mirror this kernel.
// What holds it above its bound at K = Q = 256: each row's passes run one
// after another between block barriers (clear, claim, stream, read), and
// their shared-memory atomics (the 64-bit claims most) set how long a row
// takes; fewer threads a row (a warp) or fewer rows a block is slower, and
// so are an occupancy bitmap beside 32-bit keys (a repeated query takes a
// slot of its own and lengthens every probe run) and warp-level merging of
// repeats before the atomics (measured on an H100).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;   // a block's tables, at most
constexpr uint32_t kHashMult = 0x9E3779B1u;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kMaxLanes = 4;            // lanes a pass sums, at most

__device__ __forceinline__ uint32_t bucket(int32_t id, int log2h) {
  return ((uint32_t)id * kHashMult) >> (32 - log2h);
}

// The slot of `id`: claimed if the id is new to the table, else the one
// that holds it.
__device__ __forceinline__ uint32_t claim(unsigned long long* keys,
                                          int32_t id, int log2h) {
  const unsigned long long key = (uint32_t)id;
  const uint32_t mask = (1u << log2h) - 1u;
  uint32_t s = bucket(id, log2h);
  while (true) {
    const unsigned long long prev = atomicCAS(keys + s, kEmpty, key);
    if (prev == kEmpty || prev == key) return s;
    s = (s + 1u) & mask;
  }
}

// The slot holding `id`, or -1.
__device__ __forceinline__ int find(const unsigned long long* keys,
                                    int32_t id, int log2h) {
  const unsigned long long key = (uint32_t)id;
  const uint32_t mask = (1u << log2h) - 1u;
  uint32_t s = bucket(id, log2h);
  while (true) {
    const unsigned long long k = keys[s];
    if (k == key) return (int)s;
    if (k == kEmpty) return -1;
    s = (s + 1u) & mask;
  }
}

template <int W>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&v)[W]) {
  if constexpr (W == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void copy(const int32_t (&a)[W], int32_t (&v)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = a[w];
}

// The W entries from k on: their ids and their first nl lanes.
template <int W>
__device__ __forceinline__ void load_entries(
    const int32_t* r, const int32_t* ln, int K, int k, int nl,
    int32_t (&id)[W], int32_t (&lane)[kMaxLanes][W]) {
  load<W>(r + k, id);
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l)
    if (l < nl) load<W>(ln + (size_t)l * K + k, lane[l]);
}

template <int W>
__device__ __forceinline__ void store(int32_t* p, const int32_t (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// WK / WQ: entries / queries a thread takes at once (4: one 16-byte word).
template <int WK, int WQ>
__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ queries,
                   const int32_t* __restrict__ lanes,
                   int32_t* __restrict__ out, int B, int K, int Q, int L,
                   int chunk, int log2h, int lanes_per_pass,
                   int rows_per_block) {
  extern __shared__ unsigned long long smem[];
  const int group = kThreads / rows_per_block;
  const int g = threadIdx.x / group, t = threadIdx.x % group;
  const int H = 1 << log2h;
  // a row's table: H keys, then lanes_per_pass x H uint32 sums
  unsigned long long* keys = smem + (size_t)g * H * (2 + lanes_per_pass) / 2;
  uint32_t* sums = reinterpret_cast<uint32_t*>(keys + H);

  // every group runs the same passes (K, Q and L are the block's), so the
  // block-wide barriers match; a group past the last row only idles
  for (long long b0 = (long long)blockIdx.x * rows_per_block; b0 < B;
       b0 += (long long)gridDim.x * rows_per_block) {
    const long long b = b0 + g;
    const bool active = b < B;
    const int32_t* r = rows + b * K;
    const int32_t* qp = queries + b * Q;
    for (int q0 = 0; q0 < Q; q0 += chunk) {
      const int nq = min(chunk, Q - q0);
      for (int l0 = 0; l0 < L; l0 += lanes_per_pass) {
        const int nl = min(lanes_per_pass, L - l0);
        const int32_t* ln = lanes + (b * L + l0) * K;
        // this thread's first words of entries, their lanes and queries,
        // in flight while the table is cleared and built
        int32_t eid[WK], elane[kMaxLanes][WK], qid[WQ];
        if (active && WK * t < K) load_entries<WK>(r, ln, K, WK * t, nl, eid,
                                                   elane);
        if (active && WQ * t < nq) load<WQ>(qp + q0 + WQ * t, qid);
        __syncthreads();   // the previous pass's reads are done
        if (l0 == 0) {
          for (int i = t; i < H; i += group) keys[i] = kEmpty;
          __syncthreads();
        }
        if (active) {
          for (int i = WQ * t; i < nq; i += WQ * group) {
            int32_t id[WQ];
            if (i == WQ * t) copy<WQ>(qid, id); else load<WQ>(qp + q0 + i, id);
#pragma unroll
            for (int w = 0; w < WQ; ++w) {
              const uint32_t s = claim(keys, id[w], log2h);
              for (int l = 0; l < nl; ++l) sums[l * H + s] = 0u;
            }
          }
        }
        __syncthreads();
        if (active) {
          for (int i = WK * t; i < K; i += WK * group) {
            if (i != WK * t) load_entries<WK>(r, ln, K, i, nl, eid, elane);
#pragma unroll
            for (int w = 0; w < WK; ++w) {
              const int s = find(keys, eid[w], log2h);
              if (s < 0) continue;
#pragma unroll
              for (int l = 0; l < kMaxLanes; ++l)
                if (l < nl) atomicAdd(sums + l * H + s, (uint32_t)elane[l][w]);
            }
          }
        }
        __syncthreads();
        if (active) {
          for (int i = WQ * t; i < nq; i += WQ * group) {
            int32_t id[WQ];
            if (i == WQ * t) copy<WQ>(qid, id); else load<WQ>(qp + q0 + i, id);
            int s[WQ];
#pragma unroll
            for (int w = 0; w < WQ; ++w) s[w] = find(keys, id[w], log2h);
            for (int l = 0; l < nl; ++l) {
              int32_t v[WQ];
#pragma unroll
              for (int w = 0; w < WQ; ++w) v[w] = (int32_t)sums[l * H + s[w]];
              store<WQ>(out + (b * L + l0 + l) * Q + q0 + i, v);
            }
          }
        }
      }
    }
  }
}

template <int WK, int WQ>
int launch(const void* rows, const void* queries, const void* lanes,
           void* out, int B, int K, int Q, int L, int chunk, int log2h,
           int lanes_per_pass, int rows_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)rows_per_block * ((size_t)4 << log2h)
                      * (2 + lanes_per_pass);
  const long long blocks = ((long long)B + rows_per_block - 1)
                           / rows_per_block;
  const int grid = (int)(blocks < (1 << 30) ? blocks : (1 << 30));
  hash_lookup_kernel<WK, WQ><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)rows, (const int32_t*)queries, (const int32_t*)lanes,
      (int32_t*)out, B, K, Q, L, chunk, log2h, lanes_per_pass,
      rows_per_block);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// rows [B, K], queries [B, Q], lanes [B, L, K] and out [B, L, Q], all
// int32, contiguous; the plan as ops/lookup.py:hash_plan gives it.
int fused_lookup(const void* rows, const void* queries, const void* lanes,
                 void* out, int B, int K, int Q, int L, int chunk, int log2h,
                 int lanes_per_pass, int rows_per_block, void* stream) {
  if (B < 0 || K < 1 || Q < 0 || L < 1 || chunk < 1 || (Q && chunk > Q)
      || log2h < 1 || log2h > 20 || (1 << log2h) < 2 * chunk
      || lanes_per_pass < 1 || lanes_per_pass > L
      || lanes_per_pass > kMaxLanes
      || (rows_per_block != 1 && rows_per_block != 2 && rows_per_block != 4
          && rows_per_block != 8)
      || (long long)rows_per_block * (4ll << log2h) * (2 + lanes_per_pass)
             > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vk = K % 4 == 0 && aligned16(rows) && aligned16(lanes);
  const bool vq = Q % 4 == 0 && chunk % 4 == 0 && aligned16(queries)
                  && aligned16(out);
  if (vk && vq)
    return launch<4, 4>(rows, queries, lanes, out, B, K, Q, L, chunk, log2h,
                        lanes_per_pass, rows_per_block, s);
  if (vk)
    return launch<4, 1>(rows, queries, lanes, out, B, K, Q, L, chunk, log2h,
                        lanes_per_pass, rows_per_block, s);
  if (vq)
    return launch<1, 4>(rows, queries, lanes, out, B, K, Q, L, chunk, log2h,
                        lanes_per_pass, rows_per_block, s);
  return launch<1, 1>(rows, queries, lanes, out, B, K, Q, L, chunk, log2h,
                      lanes_per_pass, rows_per_block, s);
}

const char* fused_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
