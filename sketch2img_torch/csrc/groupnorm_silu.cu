// Fused GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW contiguous:
//   y = silu?( x * (inv * gamma) + (beta - mean * inv * gamma) )
// with fp32 statistics per (sample, group), inv = rsqrt(var + eps), and one
// cast of the fp32 result to x's dtype.
//
// Replaces the Pallas TPU kernel sketch2img_tpu/ops/groupnorm.py::_kernel
// (launched by _fused_forward, public fused_groupnorm_silu). The TPU kernel
// walks a sequential (B, 2, HW_tiles) grid with sums carried in VMEM scratch
// and finds group sums through a C x C membership matmul; neither carries
// over. In NCHW each (b, g) group is one contiguous span of L = cg * H * W
// elements, so a group is a flat range and needs no channel bookkeeping
// until the affine step.
//
// Bound: bytes. x read once and y written once (2 * N * 2 bytes in bf16 at
// 3.35 TB/s) against ~10 flops an element.
//
// Two variants; the wrapper's plan picks one from the shape and dtype:
//
// gn_onepass (the rule). One launch, x read once. A group goes to a cluster
// of `cluster` blocks (1 to 16; one block, launched without a cluster, for a
// small group), each holding `chunk` consecutive elements of it in shared
// memory (up to 200 KB):
//   1. one thread issues 1-D bulk copies (cp.async.bulk, 32 KB pieces, one
//      mbarrier each) of the block's slice; as each piece lands, every
//      thread sums d = x - k and d^2, k the slice's first element (the
//      shift keeps sum(d^2) - sum(d)^2 / n from cancelling when the mean is
//      large against the spread);
//   2. the block's sums become its moments (count, mean, sum of squared
//      deviations from the mean), and the blocks of the cluster merge
//      theirs through distributed shared memory (barrier.cluster, then
//      ld.shared::cluster of every block's moments, merged in rank order by
//      Chan, Golub and LeVeque's pairwise update), so every block of the
//      cluster gets the same mean and variance: one reduction round where
//      a mean-then-variance scheme takes two;
//   3. each block normalises its slice from shared memory, applies the
//      affine and SiLU, and stores y with 16-byte stores.
// Cluster sizes above 8 are the card's non-portable sizes (the launch opts
// in). A misaligned pointer or a shape whose channels do not split into
// 16-byte vectors takes element-wise loads on the same plan. Measured on
// an H100 80GB HBM3 at its 700 W limit (PERF.md): small groups are
// latency-bound (~4-10 us a call: a cluster's launch and barrier cost
// about as much as the split variant's second launch); at batch 8-16 it takes 0.7-0.8x of the split
// variant's time; a block of 128 KB or more (one an SM: its load,
// statistics and store cannot overlap another block's) is slower than the
// split variant, so the plan gives one pass to groups of up to 16 x 96 KB.
//
// gn_split (for groups larger than 16 blocks of 96 KB: the VAE's 2 and 4 MB
// bf16 groups at 512^2 and at 256^2 x 512 channels, and fp32 from 2 MB).
// Two launches on a (S, B * G) grid: gn_stats writes each chunk's partial
// (sum, sum of squares of x - K, K the group's first element, which keeps
// E[x^2] - E[x]^2 from cancelling when the mean is large against the
// spread) to a scratch tensor the wrapper allocates; gn_apply folds them
// and normalises its chunk, reading x a second time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace gn {

constexpr int kBF16 = 0;
enum Variant { kOnePass = 0, kSplit = 1 };

// The launch plan (the wrapper builds one per shape and dtype and passes
// it by pointer): field order and types mirror ops/groupnorm.py's
// _PlanStruct.
struct Plan {
  int device, B, C, HW, G;
  int variant;  // Variant
  int cluster;  // one-pass: blocks a group
  int S;        // split: chunks a group
  long long chunk;  // elements a block
  int smem;     // one-pass: dynamic shared memory a block
  int threads;  // one-pass: threads a block
  float eps;
  int silu, dtype, pdtype;
};

struct Args {
  const void* x;
  void* y;
  const void* gamma;
  const void* beta;
  float2* part;     // split: (B * G, S) partial (sum, sum of squares) of x - K
  long long L;      // elements per group: (C / G) * H * W
  long long chunk;  // elements per block (a multiple of 8 on the vector path)
  int S, HW, cg, G;
  float eps;
  int silu, dtype, pdtype, vec;
};

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

// sum over the block's threads; the result is valid in warp 0
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();  // red may be reused
  return v;
}

// SiLU in fp32: y * sigmoid(y), exp and division on the special-function
// unit (relative error ~1e-6, far below a bf16 output's rounding; for very
// negative y, 1 + exp(-y) overflows and the result is the limit, 0)
__device__ __forceinline__ float finish(float y, int silu) {
  return silu ? __fdividef(y, 1.f + __expf(-y)) : y;
}

// ---- one pass ---------------------------------------------------------------

constexpr int kMaxThreads = 512;   // one-pass block size: 128, 256 or 512 (the plan's)
constexpr int kPiece = 32 * 1024;  // bytes a bulk copy
constexpr int kMaxPieces = 8;      // 256 KB: above any slice the plan makes
constexpr int kMaxSlice = 200 * 1024;

// (count, mean, sum of squared deviations from the mean) of some elements
struct Moments {
  float n, mean, m2;
};

// the moments of the union of two disjoint sets (Chan, Golub and LeVeque):
// exact up to rounding, with no E[x^2] - E[x]^2 cancellation
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  const float d = b.mean - a.mean, f = b.n / n;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

// sums of d = x - k and d^2 over eight values, as two balanced trees
__device__ __forceinline__ void shifted_sums8(const float v[8], float k, float& s, float& q) {
  float d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = v[i] - k;
  s += ((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]));
  q += (fmaf(d[0], d[0], d[1] * d[1]) + fmaf(d[2], d[2], d[3] * d[3])) +
       (fmaf(d[4], d[4], d[5] * d[5]) + fmaf(d[6], d[6], d[7] * d[7]));
}

__device__ __forceinline__ Moments shfl_down(Moments x, int o) {
  return {__shfl_down_sync(0xffffffffu, x.n, o), __shfl_down_sync(0xffffffffu, x.mean, o),
          __shfl_down_sync(0xffffffffu, x.m2, o)};
}

// merge over the lanes of a warp, lane 0 first: the result is in lane 0,
// by the same sequence of operations wherever the inputs are the same
__device__ __forceinline__ Moments warp_merge(Moments x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Moments y = shfl_down(x, o);
    if (((threadIdx.x & 31) & (2 * o - 1)) == 0) x = merge(x, y);
  }
  return x;
}

__global__ void __launch_bounds__(kMaxThreads) gn_onepass_kernel(Args a, int cluster) {
  extern __shared__ __align__(16) unsigned char xs[];
  __shared__ __align__(8) uint64_t bars[kMaxPieces];
  __shared__ float part_s[kMaxThreads / 32], part_q[kMaxThreads / 32];
  __shared__ Moments s_block;
  __shared__ float s_mean, s_inv;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int es = a.dtype == kBF16 ? 2 : 4;
  const long long bg = blockIdx.y, g0 = bg * a.L;
  const int rank = cluster > 1 ? (int)hp::cluster_rank() : 0;
  const long long lo = min(a.L, (long long)rank * a.chunk);
  const int n = (int)(min(a.L, lo + a.chunk) - lo);  // this block's elements
  const unsigned char* src = reinterpret_cast<const unsigned char*>(a.x) + (g0 + lo) * es;

  // 1. load the slice; each thread sums its elements' deviations from the
  //    slice's first element, x0, as their piece lands
  const float x0 = n > 0 ? load1(src, 0, a.dtype) : 0.f;
  float s = 0.f, q = 0.f;
  if (a.vec) {
    const int bytes = n * es, pieces = (bytes + kPiece - 1) / kPiece;
    const uint32_t bar0 = hp::smem_u32(bars), dst = hp::smem_u32(xs);
    if (tid == 0) {
      for (int p = 0; p < pieces; ++p) hp::mbar_init(bar0 + 8 * p, 1);
      hp::fence_barrier_init();
      for (int p = 0; p < pieces; ++p) {
        const int nb = min(kPiece, bytes - p * kPiece);
        hp::mbar_arrive_tx(bar0 + 8 * p, nb);
        hp::bulk_load(dst + p * kPiece, src + p * kPiece, nb, bar0 + 8 * p);
      }
    }
    __syncthreads();  // the barriers are initialised
    for (int p = 0; p < pieces; ++p) {
      hp::mbar_wait(bar0 + 8 * p, 0);
      const int end = min(bytes, (p + 1) * kPiece) / es;
#pragma unroll 4
      for (int i = p * kPiece / es + 8 * tid; i < end; i += 8 * nt) {
        float v[8];
        load8(xs, i, a.dtype, v);
        shifted_sums8(v, x0, s, q);
      }
    }
  } else {
    for (int i = tid; i < n; i += nt) {
      const float v = load1(src, i, a.dtype);
      store1(xs, i, v, a.dtype);
      s += v - x0;
      q = fmaf(v - x0, v - x0, q);
    }
  }

  // 2. the group's moments: the block's sums (warps, then warp 0), turned
  //    into moments, merged over the blocks of the cluster in rank order, so
  //    every block of the cluster gets the same mean and variance
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    part_s[warp] = s;
    part_q[warp] = q;
  }
  __syncthreads();
  Moments mo = {0.f, 0.f, 0.f};
  if (warp == 0) {
    s = warp_sum(lane < nt / 32 ? part_s[lane] : 0.f);
    q = warp_sum(lane < nt / 32 ? part_q[lane] : 0.f);
    if (n > 0) {
      const float fn = (float)n, m = s / fn;
      mo = {fn, x0 + m, fmaxf(q - s * m, 0.f)};
    }
    if (lane == 0) s_block = mo;
  }
  if (cluster > 1) {
    hp::cluster_arrive();
    hp::cluster_wait();
    if (warp == 0) {
      const uint32_t addr = hp::smem_u32(&s_block);
      mo = Moments{0.f, 0.f, 0.f};
      if (lane < cluster)
        mo = {hp::ld_cluster(addr, lane), hp::ld_cluster(addr + 4, lane),
              hp::ld_cluster(addr + 8, lane)};
      mo = warp_merge(mo);
    }
  }
  if (tid == 0) {
    s_mean = mo.mean;
    s_inv = rsqrtf(mo.m2 / (float)a.L + a.eps);
  }
  __syncthreads();
  if (cluster > 1) hp::cluster_arrive();  // done reading the other blocks' shared memory

  // 3. normalise, affine, SiLU, store
  const float mean = s_mean, inv = s_inv;
  const int c0 = (int)(bg % a.G) * a.cg;
  const unsigned off = (unsigned)lo, hw = (unsigned)a.HW;
  const long long y0 = g0 + lo;
  if (a.vec) {
#pragma unroll 4
    for (int i = 8 * tid; i < n; i += 8 * nt) {
      const int c = c0 + (int)((off + i) / hw);  // H * W % 8 == 0: one channel
      const float mul = inv * load1(a.gamma, c, a.pdtype);
      const float add = load1(a.beta, c, a.pdtype) - mean * mul;
      float v[8];
      load8(xs, i, a.dtype, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = finish(fmaf(v[k], mul, add), a.silu);
      store8(a.y, y0 + i, a.dtype, v);
    }
  } else {
    for (int i = tid; i < n; i += nt) {
      const int c = c0 + (int)((off + i) / hw);
      const float mul = inv * load1(a.gamma, c, a.pdtype);
      const float add = load1(a.beta, c, a.pdtype) - mean * mul;
      store1(a.y, y0 + i, finish(fmaf(load1(xs, i, a.dtype), mul, add), a.silu), a.dtype);
    }
  }
  if (cluster > 1) hp::cluster_wait();  // no block leaves while another may read its memory
}

// ---- split: two passes ------------------------------------------------------

constexpr int kSplitThreads = 256;

__global__ void __launch_bounds__(kSplitThreads) gn_stats_kernel(Args a) {
  const long long bg = blockIdx.y;
  const long long g0 = bg * a.L;
  const long long start = g0 + (long long)blockIdx.x * a.chunk;
  const long long end = min(g0 + a.L, start + a.chunk);
  const float shift = load1(a.x, g0, a.dtype);
  float s = 0.f, q = 0.f;
  if (a.vec) {
    for (long long i = start + 8LL * threadIdx.x; i < end; i += 8LL * kSplitThreads) {
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
    for (long long i = start + threadIdx.x; i < end; i += kSplitThreads) {
      const float d = load1(a.x, i, a.dtype) - shift;
      s += d;
      q += d * d;
    }
  }
  __shared__ float red[kSplitThreads / 32];
  s = block_sum<kSplitThreads>(s, red);
  q = block_sum<kSplitThreads>(q, red);
  if (threadIdx.x == 0) a.part[bg * a.S + blockIdx.x] = make_float2(s, q);
}

__global__ void __launch_bounds__(kSplitThreads) gn_apply_kernel(Args a) {
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
    for (long long i = start + 8LL * threadIdx.x; i < end; i += 8LL * kSplitThreads) {
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
    for (long long i = start + threadIdx.x; i < end; i += kSplitThreads) {
      const int c = c0 + (int)((i - g0) / a.HW);
      const float mul = inv * load1(a.gamma, c, a.pdtype);
      const float add = load1(a.beta, c, a.pdtype) - mean * mul;
      store1(a.y, i, finish(load1(a.x, i, a.dtype) * mul + add, a.silu), a.dtype);
    }
  }
}

// cudaFuncSetAttribute for the one-pass kernel, once per device: the most
// dynamic shared memory a plan asks for, and cluster sizes above 8
inline cudaError_t onepass_opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(gn_onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSlice);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_onepass_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

inline cudaLaunchConfig_t cluster_config(int cluster, int groups, int threads, int smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace gn

// x, y: (B, C, H, W) contiguous, dtype 0 = bf16, 1 = fp32; gamma, beta: (C,)
// in pdtype. plan: the wrapper's launch plan (gn::Plan). partials: B * G * S
// float2 of scratch on the split variant, unused on the one-pass one.
// Returns a CUDA error code.
extern "C" int groupnorm_silu(const gn::Plan* pl, void* stream, const void* x,
                              const void* gamma, const void* beta, void* y, void* partials) {
  const gn::Plan& p = *pl;
  if (p.B < 1 || p.G < 1 || p.C % p.G != 0 || p.HW < 1 || p.chunk < 1 || p.B * p.G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hp::use_device(p.device);
  if (err != cudaSuccess) return (int)err;
  gn::Args a = {};
  a.x = x;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.part = reinterpret_cast<float2*>(partials);
  a.cg = p.C / p.G;
  a.L = (long long)a.cg * p.HW;
  a.chunk = p.chunk;
  a.S = p.S;
  a.HW = p.HW;
  a.G = p.G;
  a.eps = p.eps;
  a.silu = p.silu;
  a.dtype = p.dtype;
  a.pdtype = p.pdtype;
  a.vec = p.HW % 8 == 0 && p.chunk % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == gn::kOnePass) {
    const int es = p.dtype == gn::kBF16 ? 2 : 4;
    if (p.cluster < 1 || p.cluster > 16 || p.chunk * p.cluster < a.L ||
        p.chunk * es > p.smem || p.smem > gn::kMaxSlice || p.threads % 32 != 0 ||
        p.threads < 32 || p.threads > gn::kMaxThreads)
      return (int)cudaErrorInvalidValue;
    err = gn::onepass_opt_in();
    if (err != cudaSuccess) return (int)err;
    if (p.cluster == 1) {  // a plain launch: a block alone needs no cluster
      gn::gn_onepass_kernel<<<dim3(1, p.B * p.G), p.threads, p.smem, st>>>(a, 1);
    } else {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg =
          gn::cluster_config(p.cluster, p.B * p.G, p.threads, p.smem, st, &attr);
      err = cudaLaunchKernelEx(&cfg, gn::gn_onepass_kernel, a, p.cluster);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }
  if (p.variant != gn::kSplit || p.S < 1 || (long long)p.S * p.chunk < a.L)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.S, p.B * p.G);
  gn::gn_stats_kernel<<<grid, gn::kSplitThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn::gn_apply_kernel<<<grid, gn::kSplitThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` one-pass blocks of 512 threads with `smem`
// bytes of dynamic shared memory the card holds at once (0: it cannot schedule
// one), or minus a CUDA error code.
extern "C" int groupnorm_max_active_clusters(int device, int cluster, int smem) {
  cudaError_t err = hp::use_device(device);
  if (err == cudaSuccess) err = gn::onepass_opt_in();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = gn::cluster_config(cluster, 1, gn::kMaxThreads, smem, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gn::gn_onepass_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
