// Scatter-add of rows, out[i] = sum over rows r with ids[r] == i and
// live[r] of ct[r], accumulated in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/scatter.py: _kernel (:48)
// behind _scatter_sorted (:74), reached from scatter_rows_add (:223). That
// design sorts the rows by id, permutes the cotangent within segments and
// sums one-hot chunks on the MXU: a workaround for a TPU whose unsorted
// scatter runs row by row. This card has f32 reductions in L2, so the
// kernel computes the sum directly and never sorts.
//
// What bounds it on an H100: bytes. It must read the ids and the live mask
// of every row, the ct row of every live row, and write the [n, D] f32
// output (the caller zeroes it first, one memset). On the training path
// the rows are the context-key cotangents [B, C] of which ~8% are live, so
// the live rows are ~10 MB of a ~40 MB total. What the design does about
// it:
//   * one warp takes 32 rows at a time: lane r reads id and live of row r
//     (coalesced), a ballot finds the live ones, and dead rows cost only
//     those 5 bytes; their ct rows are never read;
//   * the warp walks the live rows kRows = 8 at a time: every lane loads
//     its 4 contiguous columns of each of those rows (one 8-byte bf16x4 or
//     16-byte f32x4 load a row) before any of their reductions start, so
//     up to 8 loads are in flight, then adds each into out[id] with one
//     vector reduction (red.global.add.v4.f32, through CUDA's float4
//     atomicAdd for compute capability 9.x): 4x fewer L2 atomics than one
//     per element. A D that is no multiple of 4, or a ct or out that is not
//     aligned to a 4-element word, takes the scalar path (one atomicAdd
//     per element, the same 8 rows in flight);
//   * the grid fills the card: as many 256-thread blocks as the SMs hold
//     at once, each warp striding over the 32-row groups.
// What holds it above its bound: latency. Each group's chain (live mask,
// then ids, then the ct rows, then the reductions) is serial, a group has
// ~2.6 live rows at the training path's ~8%, and the registers of 8 rows
// in flight leave half the SM's warp slots empty (fewer registers spill;
// two groups at once, or a shared-memory list of a warp's live rows over
// 256 rows, cost more warps than they save; measured on an H100).
// The order of the additions into one output element changes from run to
// run: the result is exact up to f32 reassociation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;             // live rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// VEC: each lane owns 4 contiguous columns per 128-column strip (vector
// loads and reductions); else one column per 32-column strip.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add_kernel(const int32_t* __restrict__ ids,
                        const T* __restrict__ ct,
                        const uint8_t* __restrict__ live,
                        float* __restrict__ out, long long M, int D, int n) {
  constexpr int W = VEC ? 4 : 1;   // columns a lane owns per strip
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps * 32;
  for (long long r0 = warp0 * 32; r0 < M; r0 += stride) {
    const long long r = r0 + lane;
    int id = -1;
    if (r < M && (live == nullptr || live[r])) {
      id = ids[r];
      if (id < 0 || id >= n) id = -1;   // out of range: dropped
    }
    unsigned todo = __ballot_sync(kFull, id >= 0);
    while (todo) {
      // the next kRows live rows of the group (todo is warp-uniform)
      int row[kRows], dst[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        row[j] = -1;
        if (todo) {
          row[j] = __ffs(todo) - 1;
          todo &= todo - 1;
        }
        dst[j] = __shfl_sync(kFull, id, row[j] < 0 ? 0 : row[j]);
      }
      for (int c = W * lane; c < D; c += W * 32) {
        float4 v[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (row[j] < 0) continue;
          const T* src = ct + (size_t)(r0 + row[j]) * D + c;
          if constexpr (VEC) {
            v[j] = load4(src);
          } else {
            v[j].x = to_f32(__ldg(src));
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (row[j] < 0) continue;
          float* o = out + (size_t)dst[j] * D + c;
          if constexpr (VEC) {
            atomicAdd(reinterpret_cast<float4*>(o), v[j]);
          } else {
            atomicAdd(o, v[j].x);
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* ids, const void* ct, const void* live, void* out,
           long long M, int D, int n, cudaStream_t stream) {
  if (M <= 0 || D <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // as many blocks as the SMs hold at once (2,048 threads an SM), no more
  // than the 32-row groups need
  const long long groups = (M + 31) / 32;
  const long long want = (groups + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * (2048 / kThreads);
  const int grid = (int)(want < cap ? want : cap);
  // a 4-element word of ct or out must start on its own width
  const bool vec = D % 4 == 0 && ((uintptr_t)ct % (4 * sizeof(T))) == 0
                   && ((uintptr_t)out % 16) == 0;
  if (vec)
    scatter_rows_add_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        (const int32_t*)ids, (const T*)ct, (const uint8_t*)live, (float*)out,
        M, D, n);
  else
    scatter_rows_add_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        (const int32_t*)ids, (const T*)ct, (const uint8_t*)live, (float*)out,
        M, D, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// ids int32 [M]; ct [M, D] bfloat16 (bf16 != 0) or float32; live uint8/bool
// [M] or null (every row live); out float32 [n, D], zeroed by the caller.
int scatter_rows_add(const void* ids, const void* ct, const void* live,
                     void* out, long long M, int D, int n, int bf16,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch<__nv_bfloat16>(ids, ct, live, out, M, D, n, s);
  return launch<float>(ids, ct, live, out, M, D, n, s);
}

const char* scatter_rows_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
