// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): constants, register-fragment helpers,
// the head-dim buckets and the host-side launch helpers. The TMA, mbarrier
// and wgmma building blocks are in hopper_common.cuh.
//
// wgmma accumulator fragments (m64nN, fp32): thread (warp w, lane 4g + t)
// holds element 4j+e at row 16w + g (+8 if e >= 2), column 8j + 2t + (e & 1).
// Two neighbouring 8-column blocks, packed to bf16, are exactly one A
// fragment of a register-operand wgmma, so a probability tile computed in
// registers feeds the next product without a trip through shared memory.
//
// Head dims are zero-padded to DP (a multiple of 16, the bf16 k-step) in
// shared memory only, by TMA's out-of-bounds fill; global tensors keep their
// native d and any strides with a unit stride on d.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace fa {

constexpr float kNegInf = -1e30f;  // masked logit: exp2 gives exactly 0, never NaN
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType { kBF16 = 0, kF32 = 1 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns col and col + 1 (those < d) of one bf16 output row: one 4-byte
// store when d is even (the wrapper allocates the outputs with strides that
// are multiples of d), two 2-byte stores otherwise.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int d, bool in, float x,
                                           float y) {
  if (!in || col >= d) return;
  if ((d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    row[col] = __float2bfloat16_rn(x);
    if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(y);
  }
}

// Max / sum over the four lanes that share a row (same g).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Head-dim buckets the kernels are compiled for: the smallest one >= d.
inline int pick_dp(int d) {
  const int dps[] = {32, 48, 64, 80, 96, 128, 160, 192, 256};
  for (int dp : dps)
    if (d <= dp) return dp;
  return -1;
}

// the device's SM count, looked up once per device
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = cache[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache[dev & 63].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace fa

// Dispatch a templated launcher over the compiled head-dim buckets.
#define FA_DISPATCH_DP(d, FN, ...)                 \
  switch (fa::pick_dp(d)) {                        \
    case 32: return FN<32>(__VA_ARGS__);           \
    case 48: return FN<48>(__VA_ARGS__);           \
    case 64: return FN<64>(__VA_ARGS__);           \
    case 80: return FN<80>(__VA_ARGS__);           \
    case 96: return FN<96>(__VA_ARGS__);           \
    case 128: return FN<128>(__VA_ARGS__);         \
    case 160: return FN<160>(__VA_ARGS__);         \
    case 192: return FN<192>(__VA_ARGS__);         \
    case 256: return FN<256>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue;    \
  }
