// Flash-attention backward, dQ pass, for Hopper (sm_90a):
//   P  = exp(scale * Q K^T - LSE)            (recomputed from the saved LSE)
//   dQ = scale * sum_kv (P o (dO V^T - delta)) K,   delta = rowsum(dO o O)
// with keys at index >= kv_len masked. delta is computed outside the kernel.
//
// Replaces the Pallas TPU kernels sketch2img_tpu/ops/flash_attention.py
// ::_bwd_dq_kernel (called from _flash_backward) and ::_bwd_dq_kernel_t (called from
// _flash_backward_t, the TPU-only d-major layout).
//
// Bound: operations (three N^2 d products per head against 10 N d bytes).
// Design: one 128-thread block per (batch*head, 64-query tile); each warp
// owns 16 query rows and loops over 64-key tiles (this loop replaces the
// TPU's sequential kv grid axis). S, dP and the dQ accumulator stay in fp32
// registers; dS is packed to bf16 in registers and multiplied by a
// transposed copy of the K tile kept in shared memory. The split into a dQ
// pass and a dK/dV pass keeps the JAX package's two-kernel structure and
// needs no atomics.

#include "flash_common.cuh"

namespace fa {

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(Args a) {
  constexpr int BQ = 64, BK = 64, P = DP + 8, PT = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BQ * P;
  __nv_bfloat16* sK = sdO + BQ * P;
  __nv_bfloat16* sV = sK + BK * P;
  __nv_bfloat16* sKt = sV + BK * P;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = warp * 16;
  const long long qoff = base_offset(a.q, bh, a.H), koff = base_offset(a.k, bh, a.H),
                  voff = base_offset(a.v, bh, a.H), dooff = base_offset(a.dout, bh, a.H),
                  dqoff = base_offset(a.dq, bh, a.H);

  load_tile<BQ, DP>(sQ, P, nullptr, 0, a.q, qoff, q0, a.nq, a.d, a.dtype, a.vec);
  load_tile<BQ, DP>(sdO, P, nullptr, 0, a.dout, dooff, q0, a.nq, a.d, a.dtype, a.vec);

  // padded query rows keep lse = 0 and delta = 0: finite, zero contribution
  const int row0 = q0 + r + g, row1 = row0 + 8;
  const long long st = (long long)bh * a.nq;
  const float lse0 = row0 < a.nq ? a.lse[st + row0] * kLog2e : 0.f;
  const float lse1 = row1 < a.nq ? a.lse[st + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.nq ? a.delta[st + row0] : 0.f;
  const float dl1 = row1 < a.nq ? a.delta[st + row1] : 0.f;

  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int ntiles = (a.kv_len + BK - 1) / BK;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<BK, DP>(sK, P, sKt, PT, a.k, koff, k0, a.nk, a.d, a.dtype, a.vec);
    load_tile<BK, DP>(sV, P, nullptr, 0, a.v, voff, k0, a.nk, a.d, a.dtype, a.vec);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, P, r, kk * 16, g, t);
      load_a(ado, sdO, P, r, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, P, j * 8, kk * 16, g, t);
        mma16816(s[j], aq, b0, b1);
        load_b(b0, b1, sV, P, j * 8, kk * 16, g, t);
        mma16816(dp[j], ado, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float x = col < a.kv_len ? s[j][e] * sl2 : kNegInf;
        const float p = exp2f(x - (e < 2 ? lse0 : lse1));
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * a.scale;  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, sKt, PT, j * 8, kk * 16, g, t);
        mma16816(dq[j], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e < a.d) {
        if (row0 < a.nq) store_elem(a.dq.ptr, dqoff + (long long)row0 * a.dq.sn + col + e, dq[j][e], a.dtype);
        if (row1 < a.nq) store_elem(a.dq.ptr, dqoff + (long long)row1 * a.dq.sn + col + e, dq[j][2 + e], a.dtype);
      }
    }
  }
}

template <int DP>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64, P = DP + 8, PT = BK + 8;
  const size_t smem = (size_t)(2 * BQ * P + 2 * BK * P + DP * PT) * sizeof(__nv_bfloat16);
  dim3 grid((a.nq + BQ - 1) / BQ, a.B * a.H);
  static SmemOptIn opt;
  return launch(opt, flash_bwd_dq_kernel<DP>, grid, 128, smem, stream, a);
}

}  // namespace fa

extern "C" int flash_bwd_dq(int device, void* stream,
                            const void* q, long long qsb, long long qsh, long long qsn,
                            const void* k, long long ksb, long long ksh, long long ksn,
                            const void* v, long long vsb, long long vsh, long long vsn,
                            const void* dout, long long dsb, long long dsh, long long dsn,
                            const float* lse, const float* delta,
                            void* dq, long long qgsb, long long qgsh, long long qgsn,
                            int B, int H, int nq, int nk, int d, int kv_len, float scale,
                            int dtype) {
  cudaError_t err = fa::use_device(device);
  if (err != cudaSuccess) return (int)err;
  fa::Args a = {};
  a.q = fa::make_view(q, qsb, qsh, qsn);
  a.k = fa::make_view(k, ksb, ksh, ksn);
  a.v = fa::make_view(v, vsb, vsh, vsn);
  a.dout = fa::make_view(dout, dsb, dsh, dsn);
  a.dq = fa::make_view(dq, qgsb, qgsh, qgsn);
  a.lse = lse;
  a.delta = delta;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.d = d; a.kv_len = kv_len;
  a.scale = scale;
  a.dtype = dtype;
  a.vec = dtype == fa::kBF16 && d % 8 == 0 && fa::aligned16(a.q) && fa::aligned16(a.k) &&
          fa::aligned16(a.v) && fa::aligned16(a.dout);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FA_DISPATCH_DP(d, fa::launch_dq, a, st)
}
