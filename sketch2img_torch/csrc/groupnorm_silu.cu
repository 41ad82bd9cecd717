// Fused GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW contiguous:
//   y = silu?( x * (inv * gamma) + (beta - mean * inv * gamma) )
// with fp32 statistics per (sample, group), var = E[x^2] - E[x]^2 clamped at
// 0, inv = rsqrt(var + eps), and one cast of the fp32 result to x's dtype.
//
// Replaces the Pallas TPU kernel sketch2img_tpu/ops/groupnorm.py::_kernel
// (launched by _fused_forward, public fused_groupnorm_silu). The TPU kernel walks
// a sequential (B, 2, HW_tiles) grid with sums carried in VMEM scratch and
// finds group sums through a C x C membership matmul; neither carries over.
// In NCHW each (b, g) group is one contiguous span of cg * H * W elements,
// so a group is a flat range and needs no channel bookkeeping until the
// affine step.
//
// Bound: bytes. The work is a read of x for the statistics, a read of x and
// a write of y for the normalisation: at least 2 * N * 2 bytes in bf16
// (x read once, y written once) at 3.35 TB/s, against ~10 flops per element.
//
// Design: a split reduction, because a batch-1 request has only B * G = 32
// groups and one VAE group at 512^2 x 128 channels holds 1 M elements; one
// block per group would leave 100 of the 132 SMs idle.
//   pass 1 (gn_stats): grid (S, B * G). Block (s, bg) sums its chunk of the
//     group in fp32 (sum and sum of squares of x - K, with K the group's
//     first element: the shift keeps E[x^2] - E[x]^2 from cancelling when
//     the mean is large against the spread) and writes one float2 partial
//     to a scratch tensor that the wrapper allocates. No atomics: the
//     result does not depend on the order blocks run in.
//   pass 2 (gn_apply): the same grid. Warp 0 of each block folds the group's
//     S partials into mean and inv, then the block normalises its chunk.
// The wrapper picks S so that S * B * G is about four blocks per SM, with at
// least 2048 elements a block. Loads and stores are 16 bytes a thread (eight
// bf16) where H * W, the chunk and the pointers allow, else one element at a
// time. Both passes run on the caller's stream; the wrapper counts the pair
// as one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kThreads = 256;
constexpr int kBF16 = 0;

__device__ __forceinline__ float load1(const void* p, long long i, int dt) {
  return dt == kBF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                     : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store1(void* p, long long i, float v, int dt) {
  if (dt == kBF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// eight elements from index i (i % 8 == 0, 16-byte aligned base)
__device__ __forceinline__ void load8(const void* p, long long i, int dt, float v[8]) {
  if (dt == kBF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    const float4 a = f[0], b = f[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store8(void* p, long long i, int dt, const float v[8]) {
  if (dt == kBF16) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p) + i) = raw;
  } else {
    float4* f = reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i);
    f[0] = make_float4(v[0], v[1], v[2], v[3]);
    f[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* x;
  void* y;
  const void* gamma;
  const void* beta;
  float2* part;     // (B * G, S) partial (sum, sum of squares) of x - K
  long long L;      // elements per group: (C / G) * H * W
  long long chunk;  // elements per block (a multiple of 8 on the vector path)
  int S, HW, cg, G;
  float eps;
  int silu, dtype, pdtype, vec;
};

__global__ void __launch_bounds__(kThreads) gn_stats_kernel(Args a) {
  const long long bg = blockIdx.y;
  const long long g0 = bg * a.L;
  const long long start = g0 + (long long)blockIdx.x * a.chunk;
  const long long end = min(g0 + a.L, start + a.chunk);
  const float shift = load1(a.x, g0, a.dtype);
  float s = 0.f, q = 0.f;
  if (a.vec) {
    for (long long i = start + 8LL * threadIdx.x; i < end; i += 8LL * kThreads) {
      float v[8];
      load8(a.x, i, a.dtype, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[k] - shift;
        s += d;
        q += d * d;
      }
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      const float d = load1(a.x, i, a.dtype) - shift;
      s += d;
      q += d * d;
    }
  }
  __shared__ float red[2][kThreads / 32];
  s = warp_sum(s);
  q = warp_sum(q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[0][lane] : 0.f;
    q = lane < kThreads / 32 ? red[1][lane] : 0.f;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) a.part[bg * a.S + blockIdx.x] = make_float2(s, q);
  }
}

__device__ __forceinline__ float finish(float y, int silu) {
  return silu ? y / (1.f + expf(-y)) : y;
}

__global__ void __launch_bounds__(kThreads) gn_apply_kernel(Args a) {
  const long long bg = blockIdx.y;
  const int g = (int)(bg % a.G);
  const long long g0 = bg * a.L;
  const long long start = g0 + (long long)blockIdx.x * a.chunk;
  const long long end = min(g0 + a.L, start + a.chunk);
  __shared__ float s_mean, s_inv;
  if (threadIdx.x < 32) {
    float s = 0.f, q = 0.f;
    for (int k = threadIdx.x; k < a.S; k += 32) {
      const float2 p = a.part[bg * a.S + k];
      s += p.x;
      q += p.y;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (threadIdx.x == 0) {
      const float n = (float)a.L;
      const float m = s / n;  // mean of x - K
      const float var = fmaxf(q / n - m * m, 0.f);
      s_mean = load1(a.x, g0, a.dtype) + m;
      s_inv = rsqrtf(var + a.eps);
    }
  }
  __syncthreads();
  const float mean = s_mean, inv = s_inv;
  const int c0 = g * a.cg;
  if (a.vec) {
    for (long long i = start + 8LL * threadIdx.x; i < end; i += 8LL * kThreads) {
      const int c = c0 + (int)((i - g0) / a.HW);  // H * W % 8 == 0: one channel
      const float mul = inv * load1(a.gamma, c, a.pdtype);
      const float add = load1(a.beta, c, a.pdtype) - mean * mul;
      float v[8];
      load8(a.x, i, a.dtype, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = finish(v[k] * mul + add, a.silu);
      store8(a.y, i, a.dtype, v);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      const int c = c0 + (int)((i - g0) / a.HW);
      const float mul = inv * load1(a.gamma, c, a.pdtype);
      const float add = load1(a.beta, c, a.pdtype) - mean * mul;
      store1(a.y, i, finish(load1(a.x, i, a.dtype) * mul + add, a.silu), a.dtype);
    }
  }
}

}  // namespace gn

// x, y: (B, C, H, W) contiguous, dtype 0 = bf16, 1 = fp32; gamma, beta: (C,)
// in pdtype; partials: B * G * S float2 of scratch. S and chunk come from
// the wrapper's split plan (ceil(L / chunk) == S). Returns a CUDA error code.
extern "C" int groupnorm_silu(int device, void* stream, const void* x, const void* gamma,
                              const void* beta, void* y, void* partials, int B, int C, int HW,
                              int G, int S, long long chunk, float eps, int silu, int dtype,
                              int pdtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || G < 1 || C % G != 0 || HW < 1 || S < 1 || chunk < 1 || B * G > 65535)
    return (int)cudaErrorInvalidValue;
  gn::Args a = {};
  a.x = x;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.part = reinterpret_cast<float2*>(partials);
  a.cg = C / G;
  a.L = (long long)a.cg * HW;
  a.chunk = chunk;
  a.S = S;
  a.HW = HW;
  a.G = G;
  a.eps = eps;
  a.silu = silu;
  a.dtype = dtype;
  a.pdtype = pdtype;
  if ((long long)S * chunk < a.L) return (int)cudaErrorInvalidValue;
  a.vec = HW % 8 == 0 && chunk % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(S, B * G);
  gn::gn_stats_kernel<<<grid, gn::kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn::gn_apply_kernel<<<grid, gn::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
