// Device and launch helpers shared by the CUDA kernels of the port: the
// fused PE + per-link attention tiles (csrc/pe_attention_tiles.cuh and the
// forward and backward headers on it), the per-link attention
// (csrc/link_attention_*.cu) and the scatter-add.
// The per-link attention's warps own columns of a row: lane `lane` owns the
// output columns 4*lane + 128*j + i (i < 4, every j with the column below
// O); a row of O values is read 4 columns a lane, as one 8- or 16-byte
// access when O is a multiple of 4 (every row then starts 16-byte aligned
// from a 16-byte aligned base) and element by element otherwise or at the
// ragged end of the row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;             // columns a warp covers per group
constexpr float kNeg = -1e30f;
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

// dxj rounded to the weight type where the TPU kernel rounds it
// (`.astype(kdt)`; the per-link attention's backward)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive elements as floats, through the read-only data path
// (8-byte or 16-byte aligned accesses)
__device__ __forceinline__ void load4(const float* p, float* o) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The n = min(4, O - o) elements of a row from column o (zeros past n):
// one vector access when `vec` (O % 4 == 0) and n == 4, else one by one.
template <typename T>
__device__ __forceinline__ void loadn(const T* p, int n, bool vec, float* o) {
  if (vec && n == 4) {
    load4(p, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = i < n ? to_f32(p[i]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void storen(T* p, int n, bool vec, const float* v) {
  if (vec && n == 4) {
    store4(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) from_f32(v[i], p + i);
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

// four consecutive elements of shared memory as floats (8- or 16-byte
// aligned accesses)
__device__ __forceinline__ void load4_shared(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4_shared(const __nv_bfloat16* p,
                                             float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// A weight matrix [rows, O] whose leading `staged` rows sit in shared
// memory (staged by the block at its start) and whose other rows are read
// from device memory through the read-only path. Each block stages as many
// rows as its shared memory holds beside its warps' slices: at the
// collab-like widths every row, at wider ones a leading part.
template <typename T>
struct SplitRows {
  const T* shared;                      // [staged, O]
  const T* __restrict__ global;         // [rows, O]
  int staged;
};

// Copies the leading `staged` rows of K matrices [rows, O] (stored one after
// another) into shared memory [K, staged, O], with the whole block.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ w, T* dst,
                                           int K, int rows, int staged,
                                           int O) {
  const size_t per = (size_t)staged * O, n = (size_t)K * per;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t k = i / per;
    dst[i] = w[k * rows * O + (i - k * per)];
  }
}

// The n = min(4, O - o) elements of row d from column o (zeros past n),
// from wherever the row lives.
template <typename T>
__device__ __forceinline__ void row4(const SplitRows<T>& w, int d, int O,
                                     int o, int n, bool vec, float* v) {
  if (d >= w.staged) {
    loadn(w.global + (size_t)d * O + o, n, vec, v);
    return;
  }
  const T* r = w.shared + (size_t)d * O + o;
  if (vec && n == 4) {
    load4_shared(r, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? to_f32(r[i]) : 0.f;
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
    p[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// Sums each of the 8 values p[0..7] over the warp's lanes and returns the
// sum of p[lane & 7] (to the four lanes that share lane & 7); every index
// is known at compile time, so p stays in registers.
__device__ __forceinline__ float transpose_reduce8(float* p, int lane) {
  transpose_step<4>(p, lane);
  transpose_step<2>(p, lane);
  transpose_step<1>(p, lane);
  const float v = p[0] + __shfl_xor_sync(kFull, p[0], 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

// The n = min(4, O - o) floats of a warp's shared-memory row from column o
// (zeros past n): one conflict-free 16-byte access when `vec` and n == 4.
__device__ __forceinline__ void lds4(const float* p, int n, bool vec,
                                     float* v) {
  if (vec && n == 4) {
    load4_shared(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? p[i] : 0.f;
}
__device__ __forceinline__ void sts4(float* p, int n, bool vec,
                                     const float* v) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) p[i] = v[i];
}

// n rounded up to a multiple of 4 floats, so the arrays of a warp's slice
// of shared memory start 16-byte aligned
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The links' work counter of the library's kernels: 0 when a launch begins
// (at load, and reset by the previous launch's last draw). Launches of one
// library run in stream order, so no two draw from it at once.
__device__ int g_next_link = 0;

// The link a warp takes next: its lane 0 draws the next index from the
// work counter. Warps that drew long links draw fewer, where a fixed stride
// could hand one warp two of the longest and set the kernel's time by that
// warp. Every warp of the grid draws until it gets an index past the last
// link, once each, so the draw of B + (the grid's warps) - 1 is the
// launch's last and resets the counter for the next launch.
__device__ __forceinline__ int next_link(int lane, int B) {
  int b = 0;
  if (lane == 0) {
    b = atomicAdd(&g_next_link, 1);
    if (b == B + (int)(gridDim.x * (blockDim.x >> 5)) - 1)
      atomicExch(&g_next_link, 0);
  }
  return __shfl_sync(kFull, b, 0);
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

// The largest warp count <= want whose block fits `cap` bytes of shared
// memory (fixed + per_warp bytes a warp); 0 if not even one warp fits.
inline int warps_that_fit(int want, size_t fixed, size_t per_warp,
                          size_t cap) {
  for (int w = want; w > 0; --w)
    if (fixed + (size_t)w * per_warp <= cap) return w;
  return 0;
}

// Bytes of K staged row blocks [K, staged, O] of `elem`-byte elements,
// rounded up to 16 so the floats after them stay aligned.
__host__ __device__ inline size_t staged_bytes(int K, int staged, int O,
                                           size_t elem) {
  return ((size_t)K * staged * O * elem + 15) / 16 * 16;
}

// Rows of each of K weight matrices [rows, O] that fit in shared memory
// beside `used` bytes within `cap` (at most `rows`).
inline int rows_that_fit(int K, int rows, int O, size_t elem, size_t used,
                         size_t cap) {
  if (used + 16 >= cap) return 0;
  const size_t r = (cap - used - 16) / ((size_t)K * O * elem);
  return r < (size_t)rows ? (int)r : rows;
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
