// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// and the natural-log row log-sum-exp, keys at index >= kv_len masked.
//
// Replaces the Pallas TPU kernels sketch2img_tpu/ops/flash_attention.py
// ::_fwd_kernel (called from _flash_forward) and ::_fwd_kernel_t (called from
// _flash_forward_t, the d-major layout that exists only for the TPU's
// 128-wide matrix unit): one kernel covers every head dim up to 256.
//
// Bound. Per head the two products do 4 N^2 d flops and the softmax N^2
// exponentials. The H100's tensor cores run 989e12 bf16 flop/s, its
// special-function units ~3.9e12 ex2/s (16 per SM per clock), so below
// d ~ 64 the exponentials, not the tensor cores, set the least time: at the
// UNet's 64^2 sites (d = 40) they take ~1.6x the products' time. Bytes (8 N d
// a head) are far below both.
//
// Design (the FlashAttention-3 shape). One block per (batch*head, query
// tile), in one of two tiles the caller picks (`variant`, FwdTile):
//   tile 0, every head dim: 384 threads, 128 queries, two consumer
//     warpgroups (setmaxnreg 240), 128-key tiles (64 past DP = 160) in a
//     2-stage ring;
//   tile 1, head dims up to 64: 512 threads, 192 queries, three consumer
//     warpgroups (setmaxnreg 160), 192-key tiles in a 3-stage ring.
//   * the last warpgroup is the producer: after handing its registers to
//     the consumers (setmaxnreg 24), one thread issues TMA loads of the Q
//     tile once and of K and V tiles into the ring, guarded by full/empty
//     mbarrier pairs. Key tiles past kv_len are never loaded; ragged nq/nk
//     and the head-dim pad come in as TMA's out-of-bounds zeros.
//   * each consumer warpgroup owns 64 query rows. S = Q K^T is a wgmma with
//     both operands in shared memory (K-major); the online softmax runs on
//     the fp32 accumulator in registers in the exp2 domain; P, packed to
//     bf16 in registers, is the A operand of O += P V, whose B operand is
//     the V tile read MN-major through the descriptor (no transposed copy
//     of V, no scalar shared-memory stores). In tile 1 a warpgroup whose
//     rows all lie past nq (a ragged last tile) does nothing.
//   * the consumer warpgroups take turns on named barriers: one issues its
//     S = Q K^T while the others run their exponentials, so the
//     special-function units and the tensor cores can work at once, which
//     is what the exp-bound d <= 64 sites need. Three warpgroups keep more
//     warps in their exponentials than two; tile 1 pays for them with a
//     register file split four ways.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; device time of CUDA-graph
// replays): at the injection path's (16, 8, 4096, 40) tile 0 takes 1.4531 ms
// (2.6x the exponentials' bound), tile 1 1.0794 (2.0x; PyTorch's SDPA
// 1.1683), and 1.5999 -> 1.1291 ms at its 4,353 keys. Tile 1
// with 128-key tiles, two stages, one max/sum chain, round-to-nearest
// packing in integer ops, or skipping the masked tail's exponentials
// measured slower (1.11-1.36 ms); without turns, the same; tile 0 at
// 64-key tiles and two blocks an SM, 1.41 (the first design's trials: PV
// overlapped with the next exponentials, the turn handed over after PV,
// four stages, the same or slower). Tile 1 against tile 0 by grid fill:
// (1, 8, 4096, 40), 176 blocks on 132 SMs, 0.1059 against 0.0989; (2, 8,
// 4096, 40), 352 blocks, 0.1583 against 0.1922; the safety checker's (8,
// 16, 257, 64), 256 blocks, 0.0189 against 0.0231. Over few keys tile 1's
// 192-key tiles only add masked keys where they are no fewer than tile 0's:
// (4, 8, 4096, 40) over 231 keys, 0.0553 against 0.0514 (B = 16: 0.1926,
// 0.1870); over 154, 0.0427 against 0.0521; from 385 keys on, 7-25% faster.
// So ops/flash_attention.forward_variant takes tile 1 where d <= 64,
// B H ceil(nq / 192) >= 1.5 x the SM count (between the 1.33 waves where
// tile 0 wins and the 1.94 where tile 1 does) and ceil(kv / 192) <
// ceil(kv / 128).
// Only the key tile that holds kv_len is masked. O goes straight from the
// registers to the (B, N, H, d) output; the LSE is converted back to
// natural log. Inputs are bf16 (the wrapper casts fp32); scale must be > 0
// (the row maximum is taken on the raw logits).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fa {

struct FwdParams {
  hp::TmaOperand q, k, v;
  __nv_bfloat16* o;
  long long osb, osh, osn;
  float* lse;
  int H, nq, kv_len, d;
  float scale;
};

// Registers a consumer thread: O DP/2 + S BN/2 + P BN/4, P taking S's
// place as it is packed (tile 0: DP = 160, 80 + 64 + 32; DP = 256, BN = 64,
// 128 + 32 + 16; tile 1 at DP = 48: 24 + 96 + 48 of 160). Shared memory: Q
// BM x DP and STAGES x 2 x BN x DP (tile 0: DP = 48, 12 + 48 KB; DP = 160,
// 40 + 160 KB; DP = 256, 64 + 128 KB; tile 1 at DP = 48: 18 + 108 KB). Tile
// 1 takes each row's maximum and sum over four interleaved partials, not
// one chain.
template <int DP, int V>
struct FwdTile {
  static constexpr int NC = 2 + V;                   // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int REGS = V ? 160 : 240;         // a consumer thread's
  static constexpr int BM = 64 * NC;
  static constexpr int BN = DP > 160 ? 64 : V ? 192 : 128;
  static constexpr int STAGES = 2 + V;
  static constexpr int ACC = V ? 4 : 1;              // partial row maxima and sums
  static constexpr int SW = hp::swizzle_bytes(DP), PW = SW / 2, NP = DP / PW;
  static constexpr int Q_BYTES = BM * DP * 2, KV_BYTES = BN * DP * 2;
  static constexpr int OFF_KV = Q_BYTES;  // stage s: K at OFF_KV + 2 s KV_BYTES, then V
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, int V>
__global__ void __launch_bounds__(FwdTile<DP, V>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  using T = FwdTile<DP, V>;
  constexpr int BM = T::BM, BN = T::BN, SW = T::SW, PW = T::PW, ST = T::STAGES, NC = T::NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = hp::smem_u32(hp::align1024(smem_raw));
  // mbarriers: Q full, then full[s], then empty[s]
  const uint32_t bar_q = sbase + T::OFF_BAR;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H, q0 = blockIdx.x * BM;
  const int ntiles = (p.kv_len + BN - 1) / BN;
  // consumer warpgroups that own a query row: in tile 1 the others of a
  // ragged last tile do nothing (tile 0 keeps both: a runtime count there
  // measured 3-5% slower at d = 40)
  const int na = V ? min(NC, (p.nq - q0 + 63) / 64) : NC;

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(bar_q + 8 * (1 + s), 1);
      hp::mbar_init(bar_q + 8 * (1 + ST + s), 4 * na);  // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer ----
    hp::regs_dec<24>();
    if (tid == 128 * NC) {
      hp::mbar_arrive_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NP; ++c) hp::tma_load(sbase + c * BM * SW, p.q, bar_q, c * PW, q0, h, b);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % ST;
        const uint32_t full = bar_q + 8 * (1 + s);
        hp::mbar_wait(bar_q + 8 * (1 + ST + s), ((kt / ST) & 1) ^ 1);
        hp::mbar_arrive_tx(full, 2 * T::KV_BYTES);
        const uint32_t kb = sbase + T::OFF_KV + s * 2 * T::KV_BYTES, vb = kb + T::KV_BYTES;
#pragma unroll
        for (int c = 0; c < T::NP; ++c) {
          hp::tma_load(kb + c * BN * SW, p.k, full, c * PW, kt * BN, h, b);
          hp::tma_load(vb + c * BN * SW, p.v, full, c * PW, kt * BN, h, b);
        }
      }
    }
  } else if (wg < na) {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) ----
    hp::regs_inc<T::REGS>();
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // raw-logit row max, partial sums
    const float sl2 = p.scale * kLog2e;
    const uint32_t qa = sbase + wg * 64 * SW;
    // named barrier 1 + w: warpgroup w's turn to issue, in the order 0, 1, .., na-1
    const bool rotate = na > 1;
    const int turn = 1 + wg, next = 1 + (wg + 1) % na;
    if (rotate && wg == na - 1) hp::bar_arrive(1, 256);  // warpgroup 0 goes first
    hp::mbar_wait(bar_q, 0);

    for (int kt = 0; kt < ntiles; ++kt) {
      const int s = kt % ST;
      const uint32_t kb = sbase + T::OFF_KV + s * 2 * T::KV_BYTES, vb = kb + T::KV_BYTES;
      hp::mbar_wait(bar_q + 8 * (1 + s), (kt / ST) & 1);

      float sc[BN / 2];
      if (rotate) hp::bar_sync(turn, 256);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk * 16 / PW;
        const uint32_t off = (kk * 16 % PW) * 2;
        hp::Wgmma<BN>::ss(sc, hp::desc<SW>(qa + c * BM * SW + off, 16, 8 * SW),
                          hp::desc<SW>(kb + c * BN * SW + off, 16, 8 * SW), kk > 0);
      }
      hp::wgmma_commit();
      // the next one's turn
      if (rotate && (wg != na - 1 || kt + 1 < ntiles)) hp::bar_arrive(next, 256);
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);

      // accumulator element 4j+e: row g (+8 if e >= 2), key kt BN + 8j + 2t + (e & 1)
      const int k0 = kt * BN;
      if (k0 + BN > p.kv_len) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * t + (e & 1) >= p.kv_len) sc[4 * j + e] = kNegInf;
      }
      // row maxima and sums over ACC interleaved partials (ACC = 1: one chain)
      constexpr int ACC = T::ACC;
      float a0[ACC], a1[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) a0[i] = a1[i] = i == 0 ? m0 : kNegInf;
      a1[0] = m1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        a0[j % ACC] = fmaxf(a0[j % ACC], fmaxf(sc[4 * j], sc[4 * j + 1]));
        a1[j % ACC] = fmaxf(a1[j % ACC], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int w = ACC / 2; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          a0[i] = fmaxf(a0[i], a0[i + w]);
          a1[i] = fmaxf(a1[i], a1[i + w]);
        }
      const float mx0 = quad_max(a0[0]), mx1 = quad_max(a1[0]);
      const float al0 = hp::ex2((m0 - mx0) * sl2), al1 = hp::ex2((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float ms0 = m0 * sl2, ms1 = m1 * sl2;
#pragma unroll
      for (int i = 0; i < ACC; ++i) a0[i] = a1[i] = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sc[4 * j] = hp::ex2(fmaf(sc[4 * j], sl2, -ms0));
        sc[4 * j + 1] = hp::ex2(fmaf(sc[4 * j + 1], sl2, -ms0));
        sc[4 * j + 2] = hp::ex2(fmaf(sc[4 * j + 2], sl2, -ms1));
        sc[4 * j + 3] = hp::ex2(fmaf(sc[4 * j + 3], sl2, -ms1));
        a0[j % ACC] += sc[4 * j] + sc[4 * j + 1];
        a1[j % ACC] += sc[4 * j + 2] + sc[4 * j + 3];
      }
#pragma unroll
      for (int w = ACC / 2; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          a0[i] += a0[i + w];
          a1[i] += a1[i + w];
        }
      const float ls0 = a0[0], ls1 = a1[0];
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // two neighbouring 8-key column blocks of S are one A fragment of P V
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hp::Wgmma<DP>::rs(o, pa[kk], hp::desc<SW>(vb + kk * 16 * SW, BN * SW, 8 * SW), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(bar_q + 8 * (1 + ST + s));  // stage s is free
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
    __nv_bfloat16* ob = p.o + (long long)b * p.osb + (long long)h * p.osh;
    __nv_bfloat16* o0 = ob + (long long)row0 * p.osn;
    __nv_bfloat16* o1 = ob + (long long)row1 * p.osn;
    const bool in0 = row0 < p.nq, in1 = row1 < p.nq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= e < 2 ? inv0 : inv1;
      store_pair(o0, j * 8 + 2 * t, p.d, in0, o[4 * j], o[4 * j + 1]);
      store_pair(o1, j * 8 + 2 * t, p.d, in1, o[4 * j + 2], o[4 * j + 3]);
    }
    if (t == 0) {
      if (in0) p.lse[(long long)bh * p.nq + row0] = (m0 * sl2 + log2f(l0)) * kLn2;
      if (in1) p.lse[(long long)bh * p.nq + row1] = (m1 * sl2 + log2f(l1)) * kLn2;
    }
  }
}

struct FwdCall {
  const void *q, *k, *v;
  long long qs[3], ks[3], vs[3];  // element strides (B, H, N)
  int B, nk, variant;
};

template <int DP, int V>
int launch_fwd_tile(FwdParams& prm, const FwdCall& c, cudaStream_t stream) {
  using T = FwdTile<DP, V>;
  int err = hp::encode_operand(&prm.q, c.q, c.B, prm.H, prm.nq, prm.d, c.qs[0], c.qs[1], c.qs[2],
                               T::BM, T::SW);
  if (!err) err = hp::encode_operand(&prm.k, c.k, c.B, prm.H, c.nk, prm.d, c.ks[0], c.ks[1],
                                     c.ks[2], T::BN, T::SW);
  if (!err) err = hp::encode_operand(&prm.v, c.v, c.B, prm.H, c.nk, prm.d, c.vs[0], c.vs[1],
                                     c.vs[2], T::BN, T::SW);
  if (err) return err;
  static hp::SmemOptIn opt;
  cudaError_t e = opt.ensure(flash_fwd_kernel<DP, V>, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((prm.nq + T::BM - 1) / T::BM, c.B * prm.H);
  flash_fwd_kernel<DP, V><<<grid, T::THREADS, T::SMEM, stream>>>(prm);
  return (int)cudaGetLastError();
}

// the caller's tile (the entry point takes variant 1 up to d = 64 only)
template <int DP>
int launch_fwd(FwdParams& prm, const FwdCall& c, cudaStream_t stream) {
  if constexpr (DP <= 64) {
    if (c.variant == 1) return launch_fwd_tile<DP, 1>(prm, c, stream);
  }
  return launch_fwd_tile<DP, 0>(prm, c, stream);
}

}  // namespace fa

// q, k, v: bf16 (B, H, N, d) with a unit stride on d, a 16-byte aligned base
// and strides that are multiples of 8 elements (the wrapper sees to it);
// dtype must be 0 (bf16). o: bf16 output of the same layout rules.
// variant: the tile (FwdTile); 1 only for d <= 64.
extern "C" int flash_fwd(int device, void* stream,
                         const void* q, long long qsb, long long qsh, long long qsn,
                         const void* k, long long ksb, long long ksh, long long ksn,
                         const void* v, long long vsb, long long vsh, long long vsn,
                         void* o, long long osb, long long osh, long long osn,
                         float* lse, int B, int H, int nq, int nk, int d, int kv_len,
                         float scale, int dtype, int variant) {
  if (dtype != fa::kBF16 || !(scale > 0.f) || kv_len < 1 || kv_len > nk || variant < 0 ||
      variant > 1 || (variant > 0 && d > 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hp::use_device(device);
  if (err != cudaSuccess) return (int)err;
  fa::FwdParams prm = {};
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.osb = osb; prm.osh = osh; prm.osn = osn;
  prm.lse = lse;
  prm.H = H; prm.nq = nq; prm.kv_len = kv_len; prm.d = d;
  prm.scale = scale;
  fa::FwdCall c = {q, k, v, {qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn}, B, nk, variant};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH_DP(d, fa::launch_fwd, prm, c, st)
}
