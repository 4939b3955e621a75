// Device and launch helpers shared by the CUDA kernels of the port: the
// fused PE + per-link attention tiles (csrc/pe_attention_tiles.cuh and the
// forward and backward headers on it), the per-link attention chunks
// (csrc/link_attention_tiles.cuh) and the scatter-add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive floats through the read-only data path (16-byte
// aligned)
__device__ __forceinline__ void load4(const float* p, float* o) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// The shared memory one of `blocks` resident blocks may take: the SM's
// share less the 1 KB the system reserves per block, at most the per-block
// limit; 0 when the card cannot be queried.
inline size_t block_smem_cap(int blocks) {
  int dev = 0, optin = 0, sm_bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm_bytes,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess)
    return 0;
  const size_t share = (size_t)sm_bytes / blocks - 1024;
  return share < (size_t)optin ? share : (size_t)optin;
}

// Dynamic shared memory above 48 KB; the SM's split between shared memory
// and L1 set to the least shared memory that holds `min_blocks` blocks (the
// kernel's __launch_bounds__), so the rest of the SM's 256 KB serves as L1
// for the weights the kernels read through the read-only path; then the
// number of persistent blocks: as many as are resident at once, at most
// enough for `want` blocks. Also returns the card's SM count.
template <typename Kern>
cudaError_t persistent_grid(Kern kern, int threads, size_t smem,
                            int min_blocks, int want, int* grid, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, per_sm = 0, sm_bytes = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
      cudaSuccess)
    return err;
  // 1 KB of each block's shared memory is reserved by the system
  const size_t need = (size_t)min_blocks * (smem + 1024);
  int pct = (int)((need * 100 + sm_bytes - 1) / sm_bytes);
  if (pct > 100) pct = 100;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = want < per_sm * *sms ? want : per_sm * *sms;
  return cudaSuccess;
}

// Whether K <= 3 class widths n[0..2] (0 past K) describe the classic
// table's C columns.
inline bool class_widths_ok(int K, int C, const int* n) {
  if (K < 1 || K > 3) return false;
  int end = 0;
  for (int k = 0; k < 3; ++k) {
    if (n[k] < 0 || (k >= K && n[k] != 0)) return false;
    end += n[k];
  }
  return end == C;
}

}  // namespace
