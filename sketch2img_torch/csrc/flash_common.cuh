// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): constants, the head-dim buckets, the
// host-side launch helpers, and the warp-level mma.sync pieces of the dQ
// kernel (the forward and dK/dV kernels use wgmma, hopper_common.cuh).
//
// In the dQ kernel tensor-core products use the warp-level `mma.sync.m16n8k16` bf16 -> fp32
// instruction. A warp owns 16 rows of the output tile; operands come from
// shared memory as 32-bit (bf16x2) loads whose layouts are those of the PTX
// ISA's m16n8k16 fragments:
//   A (16x16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8,  col):  b0 (k = 2t.., n = g)  b1 (k = 2t+8.., n = g)
//   C (16x8,  f32):  c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// with g = lane / 4 and t = lane % 4. Two neighbouring C tiles (16x16) are
// exactly one A fragment once packed to bf16, so a probability tile computed
// in registers feeds the next product without a trip through shared memory.
//
// Head dims are zero-padded to DP (a multiple of 16, the bf16 k-step) in
// shared memory only; global tensors keep their native d and any strides
// with a unit stride on d.

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

// A (B, H, N, d) tensor: base pointer and element strides (d has stride 1).
struct View {
  const void* ptr;
  long long sb, sh, sn;
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  const float* lse;    // (B*H, nq), natural log
  const float* delta;  // (B*H, nq), rowsum(dO * O)
  float* lse_out;
  int B, H, nq, nk, d, kv_len;
  float scale;
  int dtype;  // DType of q, k, v, o, dout and the gradients
  int vec;    // 1: bf16 with 16-byte aligned rows -> 16-byte loads
};

__device__ __forceinline__ long long base_offset(const View& x, int bh, int H) {
  return (long long)(bh / H) * x.sb + (long long)(bh % H) * x.sh;
}

__device__ __forceinline__ __nv_bfloat16 load_elem(const void* p, long long i, int dtype) {
  if (dtype == kBF16) return reinterpret_cast<const __nv_bfloat16*>(p)[i];
  return __float2bfloat16_rn(reinterpret_cast<const float*>(p)[i]);
}

__device__ __forceinline__ void store_elem(const void* p, long long i, float x, int dtype) {
  if (dtype == kBF16)
    reinterpret_cast<__nv_bfloat16*>(const_cast<void*>(p))[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(const_cast<void*>(p))[i] = x;
}

// Copy rows [row0, row0 + ROWS) of one (N, d) head into shared memory as
// bf16, zero-filling rows >= n and columns >= d up to DP. `dst` gets the
// row-major tile (pitch `pitch`), `dst_t` (if not null) the transposed tile
// (element (r, c) at dst_t[c * pitch_t + r]). Called by the whole block.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch, __nv_bfloat16* dst_t,
                                          int pitch_t, const View& x, long long off, int row0,
                                          int n, int d, int dtype, int vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(x.ptr) + off;
    for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n && c < d)
        val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * x.sn + c);
      if (dst) *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
      if (dst_t) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst_t[(c + j) * pitch_t + r] = e[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      __nv_bfloat16 val = __float2bfloat16_rn(0.f);
      if (row0 + r < n && c < d) val = load_elem(x.ptr, off + (long long)(row0 + r) * x.sn + c, dtype);
      if (dst) dst[r * pitch + c] = val;
      if (dst_t) dst_t[c * pitch_t + r] = val;
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// A fragment of rows [r0, r0+16), columns [k0, k0+16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s, int pitch, int r0,
                                       int k0, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * pitch + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// B fragment (k in [k0, k0+16), n in [n0, n0+8)) of a tile that stores
// element (k, n) at s[n * pitch + k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* s,
                                       int pitch, int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * pitch + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Two C tiles (columns [16 kk, 16 kk + 16)) packed as one bf16 A fragment.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

inline bool aligned16(const View& x) {
  return (reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0) && x.sb % 8 == 0 && x.sh % 8 == 0 &&
         x.sn % 8 == 0;
}

inline View make_view(const void* p, long long sb, long long sh, long long sn) {
  View v;
  v.ptr = p;
  v.sb = sb;
  v.sh = sh;
  v.sn = sn;
  return v;
}

// Make `device` current unless it already is (the entry points run on
// every attention call; cudaSetDevice is not free).
inline cudaError_t use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device: each launcher instantiation keeps one of these in a static.
struct SmemOptIn {
  std::atomic<unsigned long long> done{0};

  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) done.fetch_or(bit);
    return err;
  }
};

template <typename Kernel>
inline int launch(SmemOptIn& opt, Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, const Args& a) {
  cudaError_t err = opt.ensure(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
