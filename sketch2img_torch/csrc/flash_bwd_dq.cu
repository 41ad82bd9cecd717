// Flash-attention backward, dQ pass, for Hopper (sm_90a):
//   delta = rowsum(dO o O)                    (written out for the dK/dV pass)
//   P     = exp(scale * Q K^T - LSE)          (recomputed from the saved LSE)
//   dQ    = scale * sum_kv (P o (dO V^T - delta)) K
// with keys at index >= kv_len masked.
//
// Replaces the Pallas TPU kernels sketch2img_tpu/ops/flash_attention.py
// ::_bwd_dq_kernel (called from _flash_backward) and ::_bwd_dq_kernel_t
// (called from _flash_backward_t, the TPU-only d-major layout). The JAX
// package computes delta outside its kernels (_flash_backward); here the dQ
// kernel, which holds the dO tile anyway, loads O beside it and computes
// delta per query tile, the same function in one launch less.
//
// Bound. Three N^2 d products a head (6 N^2 d flops) against N^2
// exponentials: at the UNet's 64^2 sites (d = 40) the exponentials (at
// ~3.9e12 ex2/s) take ~1.6x the products' time (at 989e12 flop/s); bytes
// (Q, dO, O, K, V read, dQ written: 12 N d a head) are far below both.
//
// Design (the flash forward's skeleton, flash_fwd.cu, with the LSE known:
// no online softmax, one more product). 384 threads a block:
//   * warpgroup 2 is the producer (setmaxnreg 24): one thread issues TMA
//     loads of the query tile's Q, dO and O once, then streams K and V
//     tiles through a full/empty mbarrier ring. Key tiles past kv_len are
//     never loaded; ragged nq/nk and the head-dim pad arrive as TMA's
//     out-of-bounds zeros, so padded query rows have Q = dO = O = 0, and
//     with LSE = delta = 0 they stay finite and are not stored.
//   * warpgroups 0 and 1 (setmaxnreg 240) are the consumers. Each first
//     sums delta for its rows from the dO and O tiles in shared memory.
//     Per key tile, S = Q K^T and dP = dO V^T are wgmma products with both
//     operands in shared memory (K and V K-major); P = ex2(S scale log2 e -
//     LSE log2 e) runs while dP is still in flight; dS = P o (dP - delta)
//     scale is packed to bf16 in registers and is the A operand of dQ +=
//     dS K, whose B operand is the K tile read MN-major through the
//     descriptor (no transposed copy of K). dQ lives in accumulator
//     registers for the whole query tile.
// Three ways to share a block between the two consumer warpgroups:
//   kRows  128 queries a block, 64 rows a warpgroup, every key tile;
//   kKeys  64 queries a block, both warpgroups on the same rows, taking
//          alternate key tiles (four stages where shared memory allows),
//          their dQ partials added through shared memory at the end (no
//          atomics): twice the blocks where 128-query blocks leave SMs idle;
//   kCols  d > 160 (buckets 192, 256): 64 queries, both warpgroups on all
//          key tiles, each with half of dQ's columns (each recomputes S and
//          dP), so dQ fits the registers.
// Registers a consumer thread (dQ + S + dP, BN keys a tile): DP = 48, BN =
// 128: 24 + 64 + 64; DP = 160, BN = 64: 80 + 32 + 32; DP = 256 (kCols):
// 64 + 32 + 32. Inputs are bf16 (the wrapper casts fp32); scale must be > 0.
// Measured on an H100 80GB HBM3 at its 700 W limit (PERF.md): 2.9x its
// exponentials' bound at (1, 8, 4096, 40) with 128-query blocks (64-query
// blocks take 1.8x as long there); at (1, 8, 1024, 80) and (1, 8, 256,
// 160), where 128-query blocks fill 64 and 16 of the 132 SMs, 64-query
// blocks take 0.73-0.79x of their time, so the launcher takes kKeys below
// a full grid.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fa {

enum DqMode { kRows = 0, kKeys = 1, kCols = 2 };

struct DqParams {
  hp::TmaOperand q, k, v, dout, o;
  const float* lse;  // (B*H, nq), natural log
  float* delta;      // (B*H, nq), written: rowsum(dO * O)
  __nv_bfloat16* dq;
  long long sb, sh, sn;  // dq element strides
  int H, nq, kv_len, d;
  float scale;
};

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt into

template <int DP, int MODE>
struct DqTile {
  static constexpr bool KEYS = MODE == kKeys, COLS = MODE == kCols;
  static constexpr int BM = MODE == kRows ? 128 : 64;  // queries a block
  static constexpr int BN = DP <= 96 ? 128 : 64;       // keys a tile
  static constexpr int DN = COLS ? DP / 2 : DP;        // dQ columns a warpgroup
  static constexpr int SW = hp::swizzle_bytes(DN), PW = SW / 2, NP = DP / PW;
  static constexpr int T_BYTES = BM * DP * 2;  // one of Q, dO, O
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int OFF_DO = T_BYTES, OFF_O = 2 * T_BYTES, OFF_KV = 3 * T_BYTES;
  static constexpr int STAGES =
      KEYS && OFF_KV + 8 * KV_BYTES + 8 * 9 + 1024 <= kMaxSmem ? 4 : 2;
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;  // stage s: K, then V
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// sum of the products of eight bf16 pairs (two 16-byte chunks)
__device__ __forceinline__ float dot8(const unsigned char* a, const unsigned char* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yb = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xa[i]), v = __bfloat1622float2(yb[i]);
    s = fmaf(u.x, v.x, fmaf(u.y, v.y, s));
  }
  return s;
}

template <int DP, int MODE>
__global__ void __launch_bounds__(384, 1) flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  using T = DqTile<DP, MODE>;
  constexpr int BM = T::BM, BN = T::BN, DN = T::DN, SW = T::SW, PW = T::PW, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  const uint32_t sbase = hp::smem_u32(smem);
  // mbarriers: Q/dO/O full, then full[s], then empty[s]
  const uint32_t bar_t = sbase + T::OFF_BAR;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H, q0 = blockIdx.x * BM;
  const int ntiles = (p.kv_len + BN - 1) / BN;

  if (tid == 0) {
    hp::mbar_init(bar_t, 1);
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(bar_t + 8 * (1 + s), 1);
      // one arrival per consumer warp that reads the stage
      hp::mbar_init(bar_t + 8 * (1 + ST + s), T::KEYS ? 4 : 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    hp::regs_dec<24>();
    if (tid == 256) {
      hp::mbar_arrive_tx(bar_t, 3 * T::T_BYTES);
#pragma unroll
      for (int c = 0; c < T::NP; ++c) {
        hp::tma_load(sbase + c * BM * SW, p.q, bar_t, c * PW, q0, h, b);
        hp::tma_load(sbase + T::OFF_DO + c * BM * SW, p.dout, bar_t, c * PW, q0, h, b);
        hp::tma_load(sbase + T::OFF_O + c * BM * SW, p.o, bar_t, c * PW, q0, h, b);
      }
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % ST;
        const uint32_t full = bar_t + 8 * (1 + s);
        hp::mbar_wait(bar_t + 8 * (1 + ST + s), ((kt / ST) & 1) ^ 1);
        hp::mbar_arrive_tx(full, 2 * T::KV_BYTES);
        const uint32_t kb = sbase + T::OFF_KV + s * 2 * T::KV_BYTES, vb = kb + T::KV_BYTES;
#pragma unroll
        for (int c = 0; c < T::NP; ++c) {
          hp::tma_load(kb + c * BN * SW, p.k, full, c * PW, kt * BN, h, b);
          hp::tma_load(vb + c * BN * SW, p.v, full, c * PW, kt * BN, h, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hp::regs_inc<240>();
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = MODE == kRows ? 64 * wg : 0;  // this warpgroup's first row in the tile
  const int c0 = T::COLS ? DN * wg : 0;        // and first column of dQ
  const int lr = r0 + warp * 16 + g;           // rows lr and lr + 8 of the tile
  const int row0 = q0 + lr, row1 = row0 + 8;
  const bool in0 = row0 < p.nq, in1 = row1 < p.nq;
  const long long st = (long long)bh * p.nq;
  const float lse0 = in0 ? p.lse[st + row0] * kLog2e : 0.f;
  const float lse1 = in1 ? p.lse[st + row1] * kLog2e : 0.f;
  hp::mbar_wait(bar_t, 0);

  // delta of rows lr, lr + 8: dO and O share one swizzled layout, and the
  // swizzle only permutes the 16-byte chunks inside a row's SW-byte line, so
  // the products are summed in layout order; the four lanes of a row take
  // every fourth chunk
  float dl0 = 0.f, dl1 = 0.f;
  {
    constexpr int CPR = SW / 16;  // chunks a panel row
    for (int ch = t; ch < DP / 8; ch += 4) {
      const int off = (ch / CPR) * BM * SW + (ch % CPR) * 16 + lr * SW;
      dl0 += dot8(smem + T::OFF_DO + off, smem + T::OFF_O + off);
      dl1 += dot8(smem + T::OFF_DO + off + 8 * SW, smem + T::OFF_O + off + 8 * SW);
    }
    dl0 = quad_sum(dl0);
    dl1 = quad_sum(dl1);
    if (t == 0 && (MODE == kRows || wg == 0)) {  // rows shared: warpgroup 0 writes
      if (in0) p.delta[st + row0] = dl0;
      if (in1) p.delta[st + row1] = dl1;
    }
  }

  float dq[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const uint32_t qa = sbase + r0 * SW, da = sbase + T::OFF_DO + r0 * SW;
  const int pc = c0 / PW;  // the panel of dQ's first column

  for (int kt = T::KEYS ? wg : 0; kt < ntiles; kt += T::KEYS ? 2 : 1) {
    const int s = kt % ST;
    const uint32_t kb = sbase + T::OFF_KV + s * 2 * T::KV_BYTES, vb = kb + T::KV_BYTES;
    hp::mbar_wait(bar_t + 8 * (1 + s), (kt / ST) & 1);

    // S = Q K^T and dP = dO V^T (queries x keys), two commit groups
    float sc[BN / 2], dp[BN / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 / PW;
      const uint32_t off = (kk * 16 % PW) * 2;
      hp::Wgmma<BN>::ss(sc, hp::desc<SW>(qa + c * BM * SW + off, 16, 8 * SW),
                        hp::desc<SW>(kb + c * BN * SW + off, 16, 8 * SW), kk > 0);
    }
    hp::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 / PW;
      const uint32_t off = (kk * 16 % PW) * 2;
      hp::Wgmma<BN>::ss(dp, hp::desc<SW>(da + c * BM * SW + off, 16, 8 * SW),
                        hp::desc<SW>(vb + c * BN * SW + off, 16, 8 * SW), kk > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();  // S is ready; dP may still run
    hp::fence_regs(sc);

    // element 4j+e: row lr (+8 if e >= 2), key kt BN + 8j + 2t + (e & 1)
    const int k0 = kt * BN;
    const bool masked = k0 + BN > p.kv_len;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool dead = masked && k0 + j * 8 + 2 * t + (e & 1) >= p.kv_len;
        sc[4 * j + e] = dead ? 0.f : hp::ex2(fmaf(sc[4 * j + e], sl2, -(e < 2 ? lse0 : lse1)));
      }
    hp::wgmma_wait<0>();
    hp::fence_regs(dp);

    // dS = P o (dP - delta) scale, packed: two neighbouring 8-key column
    // blocks are one A fragment of dQ += dS K
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float dl = (r & 1) ? dl1 : dl0;
        pa[kk][r] = pack_bf16(sc[i] * (dp[i] - dl) * p.scale, sc[i + 1] * (dp[i + 1] - dl) * p.scale);
      }
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hp::Wgmma<DN>::rs(dq, pa[kk], hp::desc<SW>(kb + pc * BN * SW + kk * 16 * SW, BN * SW, 8 * SW), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar_t + 8 * (1 + ST + s));  // stage s is free
  }

  if (T::KEYS) {
    // warpgroup 1 hands its partial dQ to warpgroup 0 through the Q/dO/O
    // tiles (no longer read once both warpgroups are past their loops); the
    // two hold the same rows and columns at the same register index
    float* red = reinterpret_cast<float*>(smem);
    const int i0 = tid & 127;
    hp::bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) red[i * 128 + i0] = dq[i];
      hp::bar_arrive(2, 256);
      return;
    }
    hp::bar_sync(2, 256);
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq[i] += red[i * 128 + i0];
  }

  __nv_bfloat16* o0 = p.dq + (long long)b * p.sb + (long long)h * p.sh + (long long)row0 * p.sn;
  __nv_bfloat16* o1 = o0 + 8 * p.sn;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    store_pair(o0, col, p.d, in0, dq[4 * j], dq[4 * j + 1]);
    store_pair(o1, col, p.d, in1, dq[4 * j + 2], dq[4 * j + 3]);
  }
}

struct DqCall {
  const void *q, *k, *v, *dout, *o;
  long long qs[3], ks[3], vs[3], ds[3], os[3];  // element strides (B, H, N)
  int B, nk, variant;
};

template <int DP, int MODE>
int launch_dq_mode(DqParams& prm, const DqCall& c, cudaStream_t stream) {
  using T = DqTile<DP, MODE>;
  int err = hp::encode_operand(&prm.q, c.q, c.B, prm.H, prm.nq, prm.d, c.qs[0], c.qs[1], c.qs[2],
                               T::BM, T::SW);
  if (!err) err = hp::encode_operand(&prm.dout, c.dout, c.B, prm.H, prm.nq, prm.d, c.ds[0],
                                     c.ds[1], c.ds[2], T::BM, T::SW);
  if (!err) err = hp::encode_operand(&prm.o, c.o, c.B, prm.H, prm.nq, prm.d, c.os[0], c.os[1],
                                     c.os[2], T::BM, T::SW);
  if (!err) err = hp::encode_operand(&prm.k, c.k, c.B, prm.H, c.nk, prm.d, c.ks[0], c.ks[1],
                                     c.ks[2], T::BN, T::SW);
  if (!err) err = hp::encode_operand(&prm.v, c.v, c.B, prm.H, c.nk, prm.d, c.vs[0], c.vs[1],
                                     c.vs[2], T::BN, T::SW);
  if (err) return err;
  static hp::SmemOptIn opt;
  cudaError_t e = opt.ensure(flash_bwd_dq_kernel<DP, MODE>, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((prm.nq + T::BM - 1) / T::BM, c.B * prm.H);
  flash_bwd_dq_kernel<DP, MODE><<<grid, 384, T::SMEM, stream>>>(prm);
  return (int)cudaGetLastError();
}

// variant 0: kKeys where 128-query blocks would leave SMs idle, else kRows;
// 1: kRows; 2: kKeys (buckets up to 160; above, always kCols)
template <int DP>
int launch_dq(DqParams& prm, const DqCall& c, cudaStream_t stream) {
  if constexpr (DP > 160) {
    return launch_dq_mode<DP, kCols>(prm, c, stream);
  } else {
    bool keys = c.variant == 2;
    if (c.variant == 0) {
      int sms = 0;
      cudaError_t e = sm_count(&sms);
      if (e != cudaSuccess) return (int)e;
      keys = (long long)((prm.nq + 127) / 128) * c.B * prm.H < sms;
    }
    return keys ? launch_dq_mode<DP, kKeys>(prm, c, stream)
                : launch_dq_mode<DP, kRows>(prm, c, stream);
  }
}

}  // namespace fa

// q, k, v, dout, o: bf16 (B, H, N, d) under the layout rules of flash_fwd;
// dtype must be 0 (bf16). delta: (B*H, nq) fp32, written for flash_bwd_dkv.
// dq: bf16 output, strides multiples of d. variant: see launch_dq.
extern "C" int flash_bwd_dq(int device, void* stream,
                            const void* q, long long qsb, long long qsh, long long qsn,
                            const void* k, long long ksb, long long ksh, long long ksn,
                            const void* v, long long vsb, long long vsh, long long vsn,
                            const void* dout, long long dsb, long long dsh, long long dsn,
                            const void* o, long long osb, long long osh, long long osn,
                            const float* lse, float* delta,
                            void* dq, long long qgsb, long long qgsh, long long qgsn,
                            int B, int H, int nq, int nk, int d, int kv_len, float scale,
                            int dtype, int variant) {
  if (dtype != fa::kBF16 || !(scale > 0.f) || kv_len < 1 || kv_len > nk || variant < 0 ||
      variant > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  fa::DqParams prm = {};
  prm.lse = lse;
  prm.delta = delta;
  prm.dq = static_cast<__nv_bfloat16*>(dq);
  prm.sb = qgsb; prm.sh = qgsh; prm.sn = qgsn;
  prm.H = H; prm.nq = nq; prm.kv_len = kv_len; prm.d = d;
  prm.scale = scale;
  fa::DqCall c = {q, k, v, dout, o, {qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn},
                  {dsb, dsh, dsn}, {osb, osh, osn}, B, nk, variant};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH_DP(d, fa::launch_dq, prm, c, st)
}
