// Scatter-add of rows, out[i] = sum over rows r with ids[r] == i and
// live[r] of ct[r], accumulated in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel lpformer_tpu/ops/pallas/scatter.py: _kernel (:48)
// behind _scatter_sorted (:74), reached from scatter_rows_add (:223). That
// design sorts the rows by id, permutes the cotangent within segments and
// sums one-hot chunks on the MXU: a workaround for a TPU whose unsorted
// scatter runs row by row. This card has f32 atomics in L2, so the kernel
// computes the sum directly and never sorts.
//
// What bounds it on an H100: bytes. It must read the ids and the live mask
// of every row, the ct row of every live row, and write the [n, D] f32
// output (the caller zeroes it first). On the training path the rows are
// the context-key cotangents [B, C] of which ~8% are live, so the live
// rows are ~10 MB of a ~40 MB total. What the design does about it:
//   * one warp takes 32 rows at a time: lane r reads id and live of row r
//     (coalesced), a ballot finds the live ones, and dead rows cost only
//     those 5 bytes; their ct rows are never read;
//   * the warp then walks the live rows; for each, the lanes read the row
//     in 32-column strips (coalesced) and add each element into out[id]
//     with one f32 atomicAdd, so no sort and no scratch is needed.
// The order of the additions into one output element changes from run to
// run: the result is exact up to f32 reassociation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add_kernel(const int32_t* __restrict__ ids,
                        const T* __restrict__ ct,
                        const uint8_t* __restrict__ live,
                        float* __restrict__ out, long long M, int D, int n) {
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
      const int bit = __ffs(todo) - 1;
      todo &= todo - 1;
      const int i = __shfl_sync(kFull, id, bit);
      const T* row = ct + (size_t)(r0 + bit) * D;
      float* dst = out + (size_t)i * D;
      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, to_f32(row[c]));
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
  // enough warps to keep the atomics in flight; each warp strides over
  // 32-row groups
  const long long groups = (M + 31) / 32;
  long long want = (groups + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * 16;
  const int grid = (int)(want < cap ? want : cap);
  scatter_rows_add_kernel<T><<<grid, kThreads, 0, stream>>>(
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
