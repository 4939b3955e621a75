// Device helpers of the fused PE + per-link attention kernels, and the two
// ways a context slot's class is found.
//
// The kernels of csrc/pe_attention_fwd.cuh and csrc/pe_attention_bwd.cuh
// are templates over a class source:
//   * TaggedClasses: the combined table, whose slots carry their class in
//     a [B, C] int32 tensor (ecls); used by pe_attention_mixed_{fwd,bwd}.cu;
//   * BlockedClasses: the classic table, whose columns are K contiguous
//     class blocks [cn | 1-hop | >1-hop]; the class of a slot is the block
//     that holds its column, found from the K block ends passed by value,
//     so no class tensor exists; used by pe_attention_{fwd,bwd}.cu.
// Lanes of a warp own 4 consecutive output columns (O <= 128) and the
// hidden units d = lane + 32*jd (dh <= 128).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxO = 128;              // lanes own 4 columns each
constexpr int kMaxJD = 4;               // dh <= 32 * kMaxJD
constexpr int kMaxDh = 32 * kMaxJD;
constexpr float kNeg = -1e30f;
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

struct TaggedClasses {
  const int32_t* ecls;                  // [B, C], clamped into [0, K)
  int K;
  __device__ __forceinline__ int of(size_t bc, int) const {
    return min(max(ecls[bc], 0), K - 1);
  }
  // the columns class k may hold, and whether slot (bc, c) is of class k
  __device__ __forceinline__ int begin(int) const { return 0; }
  __device__ __forceinline__ int end(int, int C) const { return C; }
  __device__ __forceinline__ bool holds(size_t bc, int c, int k) const {
    return of(bc, c) == k;
  }
};

struct BlockedClasses {
  // class k owns columns [stop[k-1], stop[k]) (stop[-1] = 0); the stops
  // of absent classes are C, so `of` never exceeds K - 1
  int stop[3];
  __device__ __forceinline__ int of(size_t, int c) const {
    return (c >= stop[0]) + (c >= stop[1]);
  }
  __device__ __forceinline__ int begin(int k) const {
    return k ? stop[k - 1] : 0;
  }
  __device__ __forceinline__ int end(int k, int) const { return stop[k]; }
  __device__ __forceinline__ bool holds(size_t, int, int) const {
    return true;
  }
};

// h and dxj rounded to the weight type where the TPU kernels round them
// (`.astype(kdt)`)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements as floats (8-byte or 16-byte aligned accesses)
__device__ __forceinline__ void load4(const float* p, float* o) {
  float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// sum_o row[o] * dx[o] over one W2f row (O elements, in shared memory),
// starting at a lane-dependent column so the warp's 32 rows (one per lane,
// O elements apart) fall in 32 different banks
__device__ __forceinline__ float row_dot(const float* row, const float* dx,
                                         int O, int lane) {
  float acc = 0.f;
  int j = lane % O;
  for (int t = 0; t < O; ++t) {
    acc += row[j] * dx[j];
    if (++j == O) j = 0;
  }
  return acc;
}
__device__ __forceinline__ float row_dot(const __nv_bfloat16* row,
                                         const float* dx, int O, int lane) {
  const int half = O / 2;
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row);
  float acc = 0.f;
  int j = lane % half;
  for (int t = 0; t < half; ++t) {
    const float2 w = __bfloat1622float2(r2[j]);
    acc += w.x * dx[2 * j] + w.y * dx[2 * j + 1];
    if (++j == half) j = 0;
  }
  return acc;
}

// Both directions' layer 1 and LayerNorm for one slot of class k, lanes
// owning hidden units d = lane + 32*jd: the normalised xhat_a/b and the
// rsqrt factors r_a/b (two-pass statistics, as the reference: the mean,
// then the mean of the centred squares).
__device__ __forceinline__ void ln_pair(
    const float* __restrict__ w1, const float* __restrict__ b1, int k,
    int dh, int lane, float a0, float a1, float* xa, float* xb, float& ra,
    float& rb) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int jd = 0; jd < kMaxJD; ++jd) {
    const int d = lane + 32 * jd;
    xa[jd] = xb[jd] = 0.f;
    if (d < dh) {
      const float wa = w1[(k * 2) * dh + d];
      const float wb = w1[(k * 2 + 1) * dh + d];
      const float bb = b1[k * dh + d];
      xa[jd] = a0 * wa + a1 * wb + bb;
      xb[jd] = a1 * wa + a0 * wb + bb;
      sa += xa[jd];
      sb += xb[jd];
    }
  }
  const float mua = warp_sum(sa) / dh, mub = warp_sum(sb) / dh;
  float va = 0.f, vb = 0.f;
#pragma unroll
  for (int jd = 0; jd < kMaxJD; ++jd) {
    if (lane + 32 * jd < dh) {
      xa[jd] -= mua;
      xb[jd] -= mub;
      va += xa[jd] * xa[jd];
      vb += xb[jd] * xb[jd];
    }
  }
  ra = rsqrtf(warp_sum(va) / dh + kLnEps);
  rb = rsqrtf(warp_sum(vb) / dh + kLnEps);
#pragma unroll
  for (int jd = 0; jd < kMaxJD; ++jd) {
    xa[jd] *= ra;
    xb[jd] *= rb;
  }
}

// Dynamic shared memory above 48 KB, then the number of persistent blocks:
// as many as are resident at once, at most enough for `want` blocks. Also
// returns the card's SM count.
template <typename Kern>
cudaError_t persistent_grid(Kern kern, int threads, size_t smem, int want,
                            int* grid, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = want < per_sm * *sms ? want : per_sm * *sms;
  return cudaSuccess;
}

// The classic table's blocks from K widths n[0..K-1] summing to C; false
// when the widths do not describe C columns.
inline bool blocked_classes(int K, int C, const int* n, BlockedClasses* out) {
  if (K < 1 || K > 3) return false;
  int end = 0;
  for (int k = 0; k < 3; ++k) {
    if (n[k] < 0 || (k >= K && n[k] != 0)) return false;
    end += n[k];
    out->stop[k] = k < K - 1 ? end : C;
  }
  return end == C;
}

}  // namespace
