// Flash-attention backward, dK/dV pass, for Hopper (sm_90a):
//   P  = exp(scale * Q K^T - LSE)          (recomputed from the saved LSE)
//   dV = sum_q P^T dO
//   dK = scale * sum_q (P o (dO V^T - delta))^T Q
// Keys at index >= kv_len get zero gradient.
//
// Replaces the Pallas TPU kernels sketch2img_tpu/ops/flash_attention.py
// ::_bwd_dkv_kernel (called from _flash_backward) and ::_bwd_dkv_kernel_t
// (called from _flash_backward_t, the TPU-only d-major layout).
//
// Bound. Four N^2 d products a head (8 N^2 d flops) against N^2
// exponentials: at the UNet's 64^2 sites (d = 40) the tensor cores' time
// (at 989e12 flop/s) and the special-function units' (N^2 ex2 at ~3.9e12/s)
// are about equal; bytes (10 N d a head) are far below both.
//
// Design. 384 threads a block, one block per (batch*head, key tile):
//   * warpgroup 2 is the producer (setmaxnreg 24): TMA loads K and V once,
//     then streams Q and dO tiles through a 2-stage ring (full/empty
//     mbarriers), its 32 lanes writing the tile's LSE (times log2 e) and
//     delta beside them with plain loads (a row of nq floats is 16-byte
//     aligned only for some nq, so bulk copies cannot take it).
//   * warpgroups 0 and 1 (setmaxnreg 240) work in the transposed frame:
//     S^T = K Q^T and dP^T = V dO^T are wgmma products with K and V as the
//     shared-memory A operand and the Q and dO tiles as K-major B; P^T and
//     dS^T are formed in registers and packed to bf16 there, and are the
//     register A operand of dV += P^T dO and dK += dS^T Q, whose B operands
//     are the same Q and dO tiles read MN-major through the descriptor. One
//     copy of each tile in shared memory; no transposes.
//   * dK and dV live in wgmma accumulator registers for the whole key tile.
//     Up to d = 160 each consumer warpgroup owns 64 keys and all DP columns
//     (2 x DP/2 = DP registers; with BQ = 32 queries a tile at DP >= 128,
//     d = 160 needs 160 + 32 + 16). Above that (d = 192, 256) both
//     warpgroups take the same 64 keys and each sums half the columns,
//     recomputing S^T and dP^T (the path never runs those head dims).
// Key tiles wholly past kv_len load nothing and write zeros. Inputs are
// bf16 (the wrapper casts fp32); scale must be > 0. Measured on the H100
// (PERF.md, PR 3): 3.4x its bound at (1, 8, 4096, 40), where the S^T / dP^T
// products, the exponentials and the dV / dK products of one warpgroup
// still run one after another.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fa {

struct DkvParams {
  hp::TmaOperand q, k, v, dout;
  const float* lse;    // (B*H, nq), natural log
  const float* delta;  // (B*H, nq)
  __nv_bfloat16 *dk, *dv;
  long long ksb, ksh, ksn, vsb, vsh, vsn;  // dk and dv element strides
  int H, nq, nk, kv_len, d;
  float scale;
};

// Tiles per head-dim bucket. SPLIT: both consumer warpgroups on the same 64
// keys, each with DN = DP / 2 columns of dK and dV. SW: the swizzle whose
// panel divides DN, so a warpgroup's columns start on a panel.
template <int DP>
struct DkvTile {
  static constexpr bool SPLIT = DP > 160;
  static constexpr int BKV = SPLIT ? 64 : 128;
  static constexpr int BQ = DP <= 96 ? 64 : 32;
  static constexpr int DN = SPLIT ? DP / 2 : DP;
  static constexpr int STAGES = 2;
  static constexpr int SW = hp::swizzle_bytes(DN), PW = SW / 2, NP = DP / PW;
  static constexpr int KV_BYTES = BKV * DP * 2, QT_BYTES = BQ * DP * 2;
  static constexpr int OFF_V = KV_BYTES, OFF_STAGE = 2 * KV_BYTES;  // stage s: Q, then dO
  static constexpr int OFF_STAT = OFF_STAGE + STAGES * 2 * QT_BYTES;  // lse[ST][BQ], delta[ST][BQ]
  static constexpr int OFF_BAR = OFF_STAT + STAGES * 2 * BQ * 4;
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  using T = DkvTile<DP>;
  constexpr int BKV = T::BKV, BQ = T::BQ, DN = T::DN, SW = T::SW, PW = T::PW, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  const uint32_t sbase = hp::smem_u32(smem);
  float* s_lse = reinterpret_cast<float*>(smem + T::OFF_STAT);
  float* s_delta = s_lse + ST * BQ;
  // mbarriers: K/V full, then full[s], then empty[s]
  const uint32_t bar_kv = sbase + T::OFF_BAR;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H, k0 = blockIdx.x * BKV;
  const int nqt = k0 < p.kv_len ? (p.nq + BQ - 1) / BQ : 0;  // dead key tiles stay zero

  if (tid == 0) {
    hp::mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(bar_kv + 8 * (1 + s), 32);      // the producer warp's lanes
      hp::mbar_init(bar_kv + 8 * (1 + ST + s), 8);  // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: warp 8 ----
    hp::regs_dec<24>();
    const int lane = tid & 31;
    if (tid < 288 && nqt > 0) {
      if (lane == 0) {
        hp::mbar_arrive_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NP; ++c) {
          hp::tma_load(sbase + c * BKV * SW, p.k, bar_kv, c * PW, k0, h, b);
          hp::tma_load(sbase + T::OFF_V + c * BKV * SW, p.v, bar_kv, c * PW, k0, h, b);
        }
      }
      const long long st = (long long)bh * p.nq;
      for (int qt = 0; qt < nqt; ++qt) {
        const int s = qt % ST, q0 = qt * BQ;
        const uint32_t full = bar_kv + 8 * (1 + s);
        hp::mbar_wait(bar_kv + 8 * (1 + ST + s), ((qt / ST) & 1) ^ 1);
        for (int i = lane; i < BQ; i += 32) {  // padded queries: lse = delta = 0
          const bool in = q0 + i < p.nq;
          s_lse[s * BQ + i] = in ? p.lse[st + q0 + i] * kLog2e : 0.f;
          s_delta[s * BQ + i] = in ? p.delta[st + q0 + i] : 0.f;
        }
        if (lane == 0) {
          hp::mbar_arrive_tx(full, 2 * T::QT_BYTES);
          const uint32_t qb = sbase + T::OFF_STAGE + s * 2 * T::QT_BYTES, db = qb + T::QT_BYTES;
#pragma unroll
          for (int c = 0; c < T::NP; ++c) {
            hp::tma_load(qb + c * BQ * SW, p.q, full, c * PW, q0, h, b);
            hp::tma_load(db + c * BQ * SW, p.dout, full, c * PW, q0, h, b);
          }
        } else {
          hp::mbar_arrive(full);
        }
      }
    }
  } else {
    // ---- consumers ----
    hp::regs_inc<240>();
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = T::SPLIT ? 0 : 64 * wg;   // this warpgroup's first key row in the tile
    const int c0 = T::SPLIT ? DN * wg : 0;   // and first column of dK / dV
    float dk[DN / 2], dv[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
    const int key0 = k0 + r0 + warp * 16 + g, key1 = key0 + 8;
    const bool live0 = key0 < p.kv_len, live1 = key1 < p.kv_len;
    const float sl2 = p.scale * kLog2e;
    const uint32_t ka = sbase + r0 * SW, va = sbase + T::OFF_V + r0 * SW;
    if (nqt > 0) hp::mbar_wait(bar_kv, 0);

    for (int qt = 0; qt < nqt; ++qt) {
      const int s = qt % ST;
      const uint32_t qb = sbase + T::OFF_STAGE + s * 2 * T::QT_BYTES, db = qb + T::QT_BYTES;
      hp::mbar_wait(bar_kv + 8 * (1 + s), (qt / ST) & 1);

      // S^T = K Q^T and dP^T = V dO^T (keys x queries)
      float sc[BQ / 2], dp[BQ / 2];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk * 16 / PW;
        const uint32_t off = (kk * 16 % PW) * 2;
        hp::Wgmma<BQ>::ss(sc, hp::desc<SW>(ka + c * BKV * SW + off, 16, 8 * SW),
                          hp::desc<SW>(qb + c * BQ * SW + off, 16, 8 * SW), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk * 16 / PW;
        const uint32_t off = (kk * 16 % PW) * 2;
        hp::Wgmma<BQ>::ss(dp, hp::desc<SW>(va + c * BKV * SW + off, 16, 8 * SW),
                          hp::desc<SW>(db + c * BQ * SW + off, 16, 8 * SW), kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);
      hp::fence_regs(dp);

      // element 4j+e: key row g (+8 if e >= 2), query 8j + 2t + (e & 1)
      const float* lse = s_lse + s * BQ;
      const float* dl = s_delta + s * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 L = *reinterpret_cast<const float2*>(lse + j * 8 + 2 * t);
        const float2 D = *reinterpret_cast<const float2*>(dl + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = e < 2 ? live0 : live1;
          const float pe = live ? hp::ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? L.y : L.x))) : 0.f;
          sc[4 * j + e] = pe;
          dp[4 * j + e] = pe * (dp[4 * j + e] - ((e & 1) ? D.y : D.x)) * p.scale;  // dS^T
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P^T dO, dK += dS^T Q over this warpgroup's columns [c0, c0 + DN)
      const int pc = c0 / PW;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hp::Wgmma<DN>::rs(dv, pa[kk], hp::desc<SW>(db + pc * BQ * SW + kk * 16 * SW, BQ * SW, 8 * SW), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hp::Wgmma<DN>::rs(dk, da[kk], hp::desc<SW>(qb + pc * BQ * SW + kk * 16 * SW, BQ * SW, 8 * SW), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dv);
      hp::fence_regs(dk);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(bar_kv + 8 * (1 + ST + s));  // stage s is free
    }

    const bool in0 = key0 < p.nk, in1 = key1 < p.nk;
    __nv_bfloat16* k_0 = p.dk + (long long)b * p.ksb + (long long)h * p.ksh + (long long)key0 * p.ksn;
    __nv_bfloat16* k_1 = k_0 + 8 * p.ksn;
    __nv_bfloat16* v_0 = p.dv + (long long)b * p.vsb + (long long)h * p.vsh + (long long)key0 * p.vsn;
    __nv_bfloat16* v_1 = v_0 + 8 * p.vsn;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      store_pair(k_0, col, p.d, in0, dk[4 * j], dk[4 * j + 1]);
      store_pair(k_1, col, p.d, in1, dk[4 * j + 2], dk[4 * j + 3]);
      store_pair(v_0, col, p.d, in0, dv[4 * j], dv[4 * j + 1]);
      store_pair(v_1, col, p.d, in1, dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

struct DkvCall {
  const void *q, *k, *v, *dout;
  long long qs[3], ks[3], vs[3], ds[3];  // element strides (B, H, N)
  int B;
};

template <int DP>
int launch_dkv(DkvParams& prm, const DkvCall& c, cudaStream_t stream) {
  using T = DkvTile<DP>;
  int err = hp::encode_operand(&prm.q, c.q, c.B, prm.H, prm.nq, prm.d, c.qs[0], c.qs[1], c.qs[2],
                               T::BQ, T::SW);
  if (!err) err = hp::encode_operand(&prm.dout, c.dout, c.B, prm.H, prm.nq, prm.d, c.ds[0],
                                     c.ds[1], c.ds[2], T::BQ, T::SW);
  if (!err) err = hp::encode_operand(&prm.k, c.k, c.B, prm.H, prm.nk, prm.d, c.ks[0], c.ks[1],
                                     c.ks[2], T::BKV, T::SW);
  if (!err) err = hp::encode_operand(&prm.v, c.v, c.B, prm.H, prm.nk, prm.d, c.vs[0], c.vs[1],
                                     c.vs[2], T::BKV, T::SW);
  if (err) return err;
  static SmemOptIn opt;
  cudaError_t e = opt.ensure(flash_bwd_dkv_kernel<DP>, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((prm.nk + T::BKV - 1) / T::BKV, c.B * prm.H);
  flash_bwd_dkv_kernel<DP><<<grid, 384, T::SMEM, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace fa

// q, k, v, dout: bf16 (B, H, N, d) under the layout rules of flash_fwd;
// dtype must be 0 (bf16). dk, dv: bf16 outputs, strides multiples of d.
extern "C" int flash_bwd_dkv(int device, void* stream,
                             const void* q, long long qsb, long long qsh, long long qsn,
                             const void* k, long long ksb, long long ksh, long long ksn,
                             const void* v, long long vsb, long long vsh, long long vsn,
                             const void* dout, long long dsb, long long dsh, long long dsn,
                             const float* lse, const float* delta,
                             void* dk, long long kgsb, long long kgsh, long long kgsn,
                             void* dv, long long vgsb, long long vgsh, long long vgsn,
                             int B, int H, int nq, int nk, int d, int kv_len, float scale,
                             int dtype) {
  if (dtype != fa::kBF16 || !(scale > 0.f) || kv_len < 1 || kv_len > nk) return (int)cudaErrorInvalidValue;
  cudaError_t err = fa::use_device(device);
  if (err != cudaSuccess) return (int)err;
  fa::DkvParams prm = {};
  prm.lse = lse;
  prm.delta = delta;
  prm.dk = static_cast<__nv_bfloat16*>(dk);
  prm.dv = static_cast<__nv_bfloat16*>(dv);
  prm.ksb = kgsb; prm.ksh = kgsh; prm.ksn = kgsn;
  prm.vsb = vgsb; prm.vsh = vgsh; prm.vsn = vgsn;
  prm.H = H; prm.nq = nq; prm.nk = nk; prm.kv_len = kv_len; prm.d = d;
  prm.scale = scale;
  fa::DkvCall c = {q, k, v, dout, {qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn},
                   {dsb, dsh, dsn}, B};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH_DP(d, fa::launch_dkv, prm, c, st)
}
