// Hopper (sm_90a) building blocks of the flash forward (flash_fwd.cu) and
// dK/dV (flash_bwd_dkv.cu) kernels, in raw PTX: TMA tile loads, mbarriers,
// wgmma shared-memory descriptors, warpgroup register hand-over and named
// barriers; on the host, the tensor maps TMA reads the (B, H, N, d) operands
// through.
//
// Shared-memory tiles. A (rows x DP) bf16 tile is kept as DP / PW column
// panels of PW = SW / 2 elements, panel p holding columns [p PW, p PW + PW)
// of every row at a row pitch of SW bytes, in TMA's SW-byte swizzle (SW =
// 32, 64 or 128: the widest whose panel divides the bucket, so DP = 48 and
// 80 need no padding past a 16-column atom). One TMA box fills one panel;
// columns >= d and rows past the tensor's end arrive as zeros (the pad).
// wgmma reads such a tile in either major order through one descriptor:
//   K-major (rows = M or N, contiguous = the reduction dim, Q K^T):
//     start = panel base + row offset + (k % PW) * 2, LBO unused (16),
//     SBO = 8 rows = 8 SW;
//   MN-major (rows = the reduction dim, contiguous = N, P V):
//     start = panel base + k * SW, LBO = one panel (rows SW), SBO = 8 SW.
// Every tile base is 1024-byte aligned, so the swizzle phase is that of the
// address and the descriptor's base offset stays 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ops.cuh"

namespace hp {

// widest TMA/wgmma swizzle (bytes) whose panel (SW / 2 bf16) divides `cols`
__host__ __device__ constexpr int swizzle_bytes(int cols) {
  return cols % 64 == 0 ? 128 : cols % 32 == 0 ? 64 : 32;
}

// wgmma descriptor layout code of a swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
__host__ __device__ constexpr int swizzle_code(int sw) { return sw == 128 ? 1 : sw == 64 ? 2 : 3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle_code(SW) << 62);
}

// 2^x on the special-function unit (one MUFU.EX2; -inf and huge negative x
// give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA -------------------------------------------------------------------

// A (B, H, N, d) bf16 operand as a 4-d tensor map: dim 0 is d (the true
// head dim, so columns >= d read as zeros), dims 1-3 are N, H and B in order
// of increasing stride; slot_* name the coordinate each takes.
struct TmaOperand {
  CUtensorMap map;
  int slot_n, slot_h, slot_b;
};

// one box (PW columns from `col`, the operand's box rows from `row`) into
// shared memory at `dst`, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const TmaOperand& op, uint32_t bar, int col,
                                         int row, int h, int b) {
  int c[4] = {col, 0, 0, 0};
  c[op.slot_n] = row;
  c[op.slot_h] = h;
  c[op.slot_b] = b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&op.map)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]),
      "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- warp specialisation ---------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the dynamic shared-memory window rounded up to 1024 bytes (the launch asks
// for 1 KB more than the layout needs)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the runtime
// (no -lcuda at link time)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// Error codes the entry points return beside CUDA's own: the driver refused
// a tensor map (kErrTensorMap + CUresult), or it could not be found.
constexpr int kErrTensorMap = 10000;

// Describe one (B, H, N, d) bf16 operand (element strides sb, sh, sn; unit
// stride on d) with boxes of (sw / 2 columns x box_rows rows). TMA wants a
// 16-byte aligned base and strides that are multiples of 16 bytes; the
// Python wrapper copies an operand that misses either before the call.
inline int encode_operand(TmaOperand* op, const void* ptr, int B, int H, int N, int d,
                          long long sb, long long sh, long long sn, int box_rows, int sw) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return kErrTensorMap;
  long long ext[3] = {N, H, B}, st[3] = {sn, sh, sb};
  // a dim of extent 1 is never stepped: give it a stride past the whole
  // operand, so that the strides are valid and the dims do not overlap
  long long span = d;
  for (int i = 0; i < 3; ++i) span += (ext[i] - 1) * st[i];
  span = (span + 7) / 8 * 8;
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) st[i] = span;
  int order[3] = {0, 1, 2};  // dims by increasing stride
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t gdim[4] = {(cuuint64_t)d, 0, 0, 0}, gstride[3];
  cuuint32_t box[4] = {(cuuint32_t)(sw / 2), 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    const int dim = order[i];
    gdim[1 + i] = (cuuint64_t)ext[dim];
    gstride[i] = (cuuint64_t)(st[dim] * 2);
    if (dim == 0) box[1 + i] = (cuuint32_t)box_rows;
    slot[dim] = 1 + i;
  }
  op->slot_n = slot[0];
  op->slot_h = slot[1];
  op->slot_b = slot[2];
  const CUtensorMapSwizzle swz = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  CUresult res = fn(&op->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
                    gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)res;
}

}  // namespace hp
