// Backward of the attention-and-tangent pair on Hopper's tensor cores
// (kernel K7b, the bf16 route at head dims 64 and 128).
//
// Replaces the Pallas TPU kernel `_jvp_bwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_hv.py (called through
// `_pair_bwd`), as flash_attention_hv_bwd.cu does on CUDA cores for fp32
// and the other head dims.  On K7a's operands, its lse, and the cotangents
// ĝo (of out; may be absent) and ĝt (of tout), per (b·h), with
// A = exp(S − lse) and T the tangent logits:
//
//   ĝtA = ĝt vᵀ   μ = rowsum(A⊙T)   r = rowsum(A⊙ĝtA)
//   ĝA = [ĝo | ĝt]·[v | tv]ᵀ + ĝtA⊙(T − μ) − T⊙r   ρ = rowsum(A⊙ĝA)
//   ĝT = A⊙(ĝtA − r)   ĝS = A⊙(ĝA − ρ)
//   ĝq = [ĝS | ĝT]·[k̂ ; t̂k]   ĝtq = ĝT k̂
//   ĝk̂ = [ĝSᵀ | ĝTᵀ]·[q ; tq]   ĝt̂k = ĝTᵀ q
//   ĝv = [Aᵀ | (A⊙(T − μ))ᵀ]·[ĝo ; ĝt]   ĝtv = Aᵀ ĝt
//   ĝbias = colsum(ĝS)   ĝtbias = colsum(ĝT)
//
// The statistics need no pass of their own beyond the first: with
// s₃ = rowsum(A⊙([ĝo | ĝt]·[v | tv]ᵀ + ĝtA⊙T)), ρ = s₃ − 2μr.
//
// What bounds it on an H100: 13 (n, n, d) products a call without ĝo
// (15 with it), operation-bound at the R1 surrogate's shapes (~1.0 ms at
// 989 TF/s), and no (n, n) map may reach device memory.  Design: the
// deterministic split of the CUDA-core kernel (no float atomics), each
// kernel shaped as K4-_tc's and K5-_tc's (flash_attention_hv_tc.cuh: a
// producer warp runs a TMA ring on mbarriers; two consumer warpgroups of
// 64 rows run `wgmma` on 32-column pieces of each streamed tile):
//
// 1. `hv_bwd_q_tc_kernel`, query-major, one block per (128 queries, output
//    slice, b·h):
//    q, tq, ĝt (and ĝo) resident, k̂, t̂k, v, tv streamed twice.  Pass 1
//    forms μ, r and ρ per row from S, T, ĝtA and ĝo vᵀ + ĝt tvᵀ and writes
//    them for steps 2 and 3.  Pass 2 rebuilds S, T and ĝtA, turns ĝtA into
//    ĝtA⊙(T − μ) − T⊙r − ρ in place and adds ĝo vᵀ + ĝt tvᵀ onto it by
//    `wgmma` (no fourth fp32 map), and accumulates ĝtq = ĝT k̂ and ĝq in one
//    chain over [ĝS | ĝT], both from registers with k̂, t̂k MN-major.
// 2. `hv_bwd_k_tc_kernel`, key-major, one block per (128 keys, output
//    slice, b·h): k̂,
//    t̂k, v, tv resident, q, tq, ĝt (and ĝo) and the per-query lse, μ, r, ρ
//    streamed.  Sᵀ = k̂·qᵀ and Tᵀ = [k̂ | t̂k]·[tq | q]ᵀ are K-major, the
//    xᵀ·y products take B MN-major: ĝt̂k = ĝTᵀ q and ĝk̂ = [ĝSᵀ | ĝTᵀ]·
//    [q ; tq]; the column sums are fp32 row sums of the unrounded ĝSᵀ, ĝTᵀ.
// 3. `hv_bwd_v_tc_kernel`, key-major: k̂, t̂k resident; ĝv and ĝtv from
//    A and A⊙(T − μ) alone.
//
// ĝS, ĝT, A and A⊙(T − μ) are rounded to bf16 before their products, as
// the TPU kernel casts them for the MXU; ĝk̂ and ĝt̂k are written in fp32,
// as the TPU kernel writes them.  Without ĝo (the R1 surrogate puts no
// cotangent on out) the template flag GO drops its loads and products.
// A masked key's bias and an all-masked row's lse (both NEG_INF) go to the
// log2 domain through `to_log2`, so such a row takes A = 1 at every key
// from its lse, as the plain version does.  Registers: two (64 × 64) fp32
// accumulators and three 32-column pieces a thread in each kernel.  At
// d = 128 each block accumulates one 64-column slice of its outputs
// (flash_attention_hv_tc.cuh) and the two slices' blocks each rebuild the
// logit-side products over all 128 columns: 44 (n, n, d) products a call
// without ĝo to d = 64's 26 (query-major 2 × 10 + 3, key-major 2 × 5 + 3,
// the v kernel 2 × 3 + 2).

#include <math.h>

#include "flash_attention_hv_tc.cuh"

namespace {

using namespace hv;

// query-major: q, tq, ĝt, ĝo | k̂, t̂k, v, tv | bias, tbias
template <int DA>
using LQ = Layout<DA, 4, 4, 2, 3>;
// key-major: k̂, t̂k, v, tv | q, tq, ĝt, ĝo | lse, μ, r, ρ
template <int DA>
using LK = Layout<DA, 4, 4, 4, 3>;
// key-major: k̂, t̂k | q, tq, ĝt, ĝo | lse, μ
template <int DA>
using LV = Layout<DA, 2, 4, 2, 4>;

struct Maps {
  CUtensorMap q, tq, gt, go, k, tk, v, tv;
};

struct Rows {
  const float* bias;
  const float* tbias;
  const float* lse;
  float* stats;  // (bh, nq, 3): μ, r, ρ
  int nq, nk;
};

// The per-query rows of a key-major stage: lse in the log2 domain (+inf
// past nq: A = 0 there), then the first `nstat` of μ, r, ρ (0 past nq)
template <int kCols>
__device__ __forceinline__ void stage_query_rows(float* v, const Rows& a,
                                                 size_t rows0, int q0,
                                                 int nstat) {
  for (int c = threadIdx.x % 32; c < kCols; c += 32) {
    const int qr = q0 + c;
    const bool ok = qr < a.nq;
    const float* st = a.stats + (rows0 + qr) * 3;
    v[c] = ok ? to_log2(a.lse[rows0 + qr]) : INFINITY;
    for (int x = 0; x < nstat; ++x) v[(1 + x) * kCols + c] = ok ? st[x] : 0.f;
  }
}

// Query-major products over a 32-key piece at byte `ko` of the stage at
// `ks` (k̂, t̂k, v, tv), with the warpgroup's resident rows at qw (q; tq,
// ĝt and ĝo follow at kRes steps): S, T = [tq | q]·[k̂ | t̂k]ᵀ and ĝtA.
template <int DA>
__device__ __forceinline__ void q_products(uint32_t qw, uint32_t ks,
                                           uint32_t ko, float (&sa)[KP / 2],
                                           float (&ta)[KP / 2],
                                           float (&ga)[KP / 2]) {
  using H = Heads<DA>;
  const uint32_t tqw = qw + H::kRes, gtw = qw + 2 * H::kRes;
  const uint32_t tks = ks + H::kTile, vs = ks + 2 * H::kTile;
#pragma unroll
  for (int kk = 0; kk < 4 * DA; ++kk)
    mma_ss_n<KP>(sa, desc_k(qw, kk), H::b_k(ks, ko, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4 * DA; ++kk)
    mma_ss_n<KP>(ta, desc_k(tqw, kk), H::b_k(ks, ko, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4 * DA; ++kk)
    mma_ss_n<KP>(ta, desc_k(qw, kk), H::b_k(tks, ko, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4 * DA; ++kk)
    mma_ss_n<KP>(ga, desc_k(gtw, kk), H::b_k(vs, ko, kk), kk > 0);
}

// x (+)= [ĝo | ĝt]·[v | tv]ᵀ over the same piece (ĝt tvᵀ alone without ĝo)
template <int DA, bool GO>
__device__ __forceinline__ void q_g1(uint32_t qw, uint32_t ks, uint32_t ko,
                                     float (&x)[KP / 2], bool acc) {
  using H = Heads<DA>;
  const uint32_t gtw = qw + 2 * H::kRes, gow = qw + 3 * H::kRes;
  const uint32_t vs = ks + 2 * H::kTile, tvs = ks + 3 * H::kTile;
  if (GO) {
#pragma unroll
    for (int kk = 0; kk < 4 * DA; ++kk)
      mma_ss_n<KP>(x, desc_k(gow, kk), H::b_k(vs, ko, kk), acc || kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4 * DA; ++kk)
    mma_ss_n<KP>(x, desc_k(gtw, kk), H::b_k(tvs, ko, kk),
                 acc || GO || kk > 0);
}

template <int DA, bool GO>
__global__ void __launch_bounds__(kThreads, 1)
hv_bwd_q_tc_kernel(const __grid_constant__ Maps mp, const Rows a,
                   __nv_bfloat16* __restrict__ gq,
                   __nv_bfloat16* __restrict__ gtq) {
  using L = LQ<DA>;
  using H = Heads<DA>;
  constexpr int kD = H::kD, kCols = H::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const Bars bars = init_bars(base + L::kBars, L::kStages);

  const int nq = a.nq, nk = a.nk;
  const int slice = blockIdx.x % DA;  // output columns 64·slice ..
  const int q0 = (blockIdx.x / DA) * kBlockRows;
  const int bi = blockIdx.y;
  const int ntiles = (nk + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t keys0 = (size_t)bi * nk;
  const size_t rows0 = (size_t)bi * nq;

  if (warp == kConsumers / 32) {
    const CUtensorMap* res[4] = {&mp.q, &mp.tq, &mp.gt, &mp.go};
    const CUtensorMap* str[4] = {&mp.k, &mp.tk, &mp.v, &mp.tv};
    produce<DA>(bars, base, res, GO ? 4 : 3, str, 4, q0, bi, 2 * ntiles,
                ntiles, L::kRing, L::kStage, [&](int s, int t) {
                  stage_key_rows<kCols>(vec + s * L::kVecStage,
                                        a.bias + keys0, a.tbias + keys0,
                                        t * kCols, nk);
                });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint32_t qw = base + wg * DA * kAtomBytes;

  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_blk + 8 * i;
    lse2[i] = row < nq ? to_log2(a.lse[rows0 + row]) : INFINITY;  // A = 0
  }
  mbar_wait(bars.res, 0);

  // ---- pass 1: μ, r and s₃, partial over the quad
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, s3[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(bars.full(s), (t / L::kStages) & 1);
    const uint32_t ks = base + L::kRing + s * L::kStage;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t ko = hf * KP * 128;
      float sa[KP / 2], ta[KP / 2], ga[KP / 2], xa[KP / 2];
      wgmma_fence();
      q_products<DA>(qw, ks, ko, sa, ta, ga);
      q_g1<DA, GO>(qw, ks, ko, xa, false);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(ta);
      fence_acc(ga);
      fence_acc(xa);
      const float* bv = vec + s * L::kVecStage + hf * KP;
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq2);
        const float2 t2 =
            *reinterpret_cast<const float2*>(bv + kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, cc ? b2.y : b2.x) - lse2[i]);
            const float tt = ta[r] + (cc ? t2.y : t2.x);
            mu[i] = fmaf(p, tt, mu[i]);
            rs[i] = fmaf(p, ga[r], rs[i]);
            s3[i] = fmaf(p, fmaf(ga[r], tt, xa[r]), s3[i]);
          }
      }
    }
    mbar_arrive(bars.empty(s));
  }
  float rho[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mu[i] = quad_sum(mu[i]);
    rs[i] = quad_sum(rs[i]);
    rho[i] = quad_sum(s3[i]) - 2.f * mu[i] * rs[i];
    const int row = q0 + row_blk + 8 * i;
    if (slice == 0 && row < nq && lane % 4 == 0) {
      float* st = a.stats + (rows0 + row) * 3;
      st[0] = mu[i];
      st[1] = rs[i];
      st[2] = rho[i];
    }
  }

  // ---- pass 2: the slice of ĝq and ĝtq
  float aq[32], atq[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) aq[r] = atq[r] = 0.f;
  for (int t = ntiles; t < 2 * ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(bars.full(s), (t / L::kStages) & 1);
    const uint32_t ks = base + L::kRing + s * L::kStage;
    const uint32_t tks = ks + H::kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t ko = hf * KP * 128;
      const int k16 = hf * KP / 16;
      float sa[KP / 2], ta[KP / 2], ga[KP / 2];
      wgmma_fence();
      q_products<DA>(qw, ks, ko, sa, ta, ga);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(ta);
      fence_acc(ga);
      // A stays fp32 in sa, ĝT goes to fragments, ga becomes
      // ĝtA⊙(T − μ) − T⊙r − ρ
      uint32_t tf[KP / 4];
      const float* bv = vec + s * L::kVecStage + hf * KP;
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq2);
        const float2 t2 =
            *reinterpret_cast<const float2*>(bv + kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float gT[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, cc ? b2.y : b2.x) - lse2[i]);
            const float tt = ta[r] + (cc ? t2.y : t2.x);
            gT[cc] = p * (ga[r] - rs[i]);
            ga[r] = ga[r] * (tt - mu[i]) - tt * rs[i] - rho[i];
            sa[r] = p;
          }
          tf[2 * j + i] = pack_bf16(gT[0], gT[1]);
        }
      }
      // ĝA − ρ: ĝo vᵀ + ĝt tvᵀ onto ga; ĝtq += ĝT·k̂
      wgmma_fence();
      q_g1<DA, GO>(qw, ks, ko, ga, true);
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(atq, tf + 4 * kk, H::b_mn(ks, slice, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(ga);
      fence_acc(atq);
      uint32_t sf[KP / 4];
#pragma unroll
      for (int r = 0; r < KP / 4; ++r)
        sf[r] = pack_bf16(sa[2 * r] * ga[2 * r], sa[2 * r + 1] * ga[2 * r + 1]);
      // ĝq += [ĝS | ĝT]·[k̂ ; t̂k]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(aq, sf + 4 * kk, H::b_mn(ks, slice, k16 + kk));
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(aq, tf + 4 * kk, H::b_mn(tks, slice, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(aq);
    }
    mbar_arrive(bars.empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_blk + 8 * i;
    if (row >= nq) continue;
    const size_t off = (rows0 + row) * kD + 64 * slice;
    store_row(gq + off, aq, i, 1.f);
    store_row(gtq + off, atq, i, 1.f);
  }
}

template <int DA, bool GO>
__global__ void __launch_bounds__(kThreads, 1)
hv_bwd_k_tc_kernel(const __grid_constant__ Maps mp, const Rows a,
                   float* __restrict__ gk, float* __restrict__ gtk,
                   float* __restrict__ gbias, float* __restrict__ gtbias) {
  using L = LK<DA>;
  using H = Heads<DA>;
  constexpr int kD = H::kD, kCols = H::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const Bars bars = init_bars(base + L::kBars, L::kStages);

  const int nq = a.nq, nk = a.nk;
  const int slice = blockIdx.x % DA;  // output columns 64·slice ..
  const int k0 = (blockIdx.x / DA) * kBlockRows;
  const int bi = blockIdx.y;
  const int ntiles = (nq + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t keys0 = (size_t)bi * nk;
  const size_t rows0 = (size_t)bi * nq;

  if (warp == kConsumers / 32) {
    const CUtensorMap* res[4] = {&mp.k, &mp.tk, &mp.v, &mp.tv};
    const CUtensorMap* str[4] = {&mp.q, &mp.tq, &mp.gt, &mp.go};
    produce<DA>(bars, base, res, 4, str, GO ? 4 : 3, k0, bi, ntiles, ntiles,
                L::kRing, L::kStage, [&](int s, int t) {
                  stage_query_rows<kCols>(vec + s * L::kVecStage, a, rows0,
                                          t * kCols, 3);
                });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint32_t kw = base + wg * DA * kAtomBytes;
  const uint32_t tkw = kw + H::kRes, vw = kw + 2 * H::kRes,
                 tvw = kw + 3 * H::kRes;

  // per key row: bias (log2 domain; −inf past nk: A = 0) and tbias
  float b2[2], tb[2], cs[2] = {0.f, 0.f}, cts[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_blk + 8 * i;
    const bool ok = key < nk;
    b2[i] = ok ? to_log2(a.bias[keys0 + key]) : -INFINITY;
    tb[i] = ok ? a.tbias[keys0 + key] : 0.f;
  }
  float ak[32], atk[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) ak[r] = atk[r] = 0.f;
  mbar_wait(bars.res, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(bars.full(s), (t / L::kStages) & 1);
    const uint32_t qs = base + L::kRing + s * L::kStage;
    const uint32_t tqs = qs + H::kTile, gts = qs + 2 * H::kTile,
                   gos = qs + 3 * H::kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      // rows are keys, columns the queries KP·hf .. of the tile
      const uint32_t qo = hf * KP * 128;
      const int k16 = hf * KP / 16;
      float sa[KP / 2], ta[KP / 2], ga[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(sa, desc_k(kw, kk), H::b_k(qs, qo, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ta, desc_k(kw, kk), H::b_k(tqs, qo, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ta, desc_k(tkw, kk), H::b_k(qs, qo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ga, desc_k(vw, kk), H::b_k(gts, qo, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(ta);
      fence_acc(ga);

      const float* v = vec + s * L::kVecStage + hf * KP;
      uint32_t tf[KP / 4];
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(v + 8 * j + cq2);
        const float2 m2 =
            *reinterpret_cast<const float2*>(v + kCols + 8 * j + cq2);
        const float2 r2 =
            *reinterpret_cast<const float2*>(v + 2 * kCols + 8 * j + cq2);
        const float2 h2 =
            *reinterpret_cast<const float2*>(v + 3 * kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float gT[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            const float rc = cc ? r2.y : r2.x;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, b2[i]) - (cc ? l2.y : l2.x));
            const float tt = ta[r] + tb[i];
            gT[cc] = p * (ga[r] - rc);
            cts[i] += gT[cc];  // unrounded, as the plain version sums it
            ga[r] = ga[r] * (tt - (cc ? m2.y : m2.x)) - tt * rc -
                    (cc ? h2.y : h2.x);
            sa[r] = p;
          }
          tf[2 * j + i] = pack_bf16(gT[0], gT[1]);
        }
      }
      // (ĝo vᵀ + ĝt tvᵀ)ᵀ onto ga; ĝt̂k += ĝTᵀ·q
      wgmma_fence();
      if (GO) {
#pragma unroll
        for (int kk = 0; kk < 4 * DA; ++kk)
          mma_ss_n<KP>(ga, desc_k(vw, kk), H::b_k(gos, qo, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ga, desc_k(tvw, kk), H::b_k(gts, qo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(atk, tf + 4 * kk, H::b_mn(qs, slice, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(ga);
      fence_acc(atk);
      uint32_t sf[KP / 4];
#pragma unroll
      for (int r = 0; r < KP / 4; ++r) {
        const float c0 = sa[2 * r] * ga[2 * r];
        const float c1 = sa[2 * r + 1] * ga[2 * r + 1];
        cs[r % 2] += c0 + c1;  // row i = r % 2; unrounded
        sf[r] = pack_bf16(c0, c1);
      }
      // ĝk̂ += [ĝSᵀ | ĝTᵀ]·[q ; tq]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(ak, sf + 4 * kk, H::b_mn(qs, slice, k16 + kk));
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(ak, tf + 4 * kk, H::b_mn(tqs, slice, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(ak);
    }
    mbar_arrive(bars.empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float c_s = quad_sum(cs[i]);
    const float c_t = quad_sum(cts[i]);
    const int key = k0 + row_blk + 8 * i;
    if (key >= nk) continue;
    const size_t off = (keys0 + key) * kD + 64 * slice;
    store_row(gk + off, ak, i, 1.f);
    store_row(gtk + off, atk, i, 1.f);
    if (slice == 0 && lane % 4 == 0) {
      gbias[keys0 + key] = c_s;
      gtbias[keys0 + key] = c_t;
    }
  }
}

template <int DA, bool GO>
__global__ void __launch_bounds__(kThreads, 1)
hv_bwd_v_tc_kernel(const __grid_constant__ Maps mp, const Rows a,
                   __nv_bfloat16* __restrict__ gv,
                   __nv_bfloat16* __restrict__ gtv) {
  using L = LV<DA>;
  using H = Heads<DA>;
  constexpr int kD = H::kD, kCols = H::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const Bars bars = init_bars(base + L::kBars, L::kStages);

  const int nq = a.nq, nk = a.nk;
  const int slice = blockIdx.x % DA;  // output columns 64·slice ..
  const int k0 = (blockIdx.x / DA) * kBlockRows;
  const int bi = blockIdx.y;
  const int ntiles = (nq + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t keys0 = (size_t)bi * nk;
  const size_t rows0 = (size_t)bi * nq;

  if (warp == kConsumers / 32) {
    const CUtensorMap* res[2] = {&mp.k, &mp.tk};
    const CUtensorMap* str[4] = {&mp.q, &mp.tq, &mp.gt, &mp.go};
    produce<DA>(bars, base, res, 2, str, GO ? 4 : 3, k0, bi, ntiles, ntiles,
                L::kRing, L::kStage, [&](int s, int t) {
                  stage_query_rows<kCols>(vec + s * L::kVecStage, a, rows0,
                                          t * kCols, 1);
                });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint32_t kw = base + wg * DA * kAtomBytes;
  const uint32_t tkw = kw + H::kRes;

  float b2[2], tb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_blk + 8 * i;
    const bool ok = key < nk;
    b2[i] = ok ? to_log2(a.bias[keys0 + key]) : -INFINITY;
    tb[i] = ok ? a.tbias[keys0 + key] : 0.f;
  }
  float av[32], atv[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) av[r] = atv[r] = 0.f;
  mbar_wait(bars.res, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(bars.full(s), (t / L::kStages) & 1);
    const uint32_t qs = base + L::kRing + s * L::kStage;
    const uint32_t tqs = qs + H::kTile, gts = qs + 2 * H::kTile,
                   gos = qs + 3 * H::kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t qo = hf * KP * 128;
      const int k16 = hf * KP / 16;
      float sa[KP / 2], ta[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(sa, desc_k(kw, kk), H::b_k(qs, qo, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ta, desc_k(kw, kk), H::b_k(tqs, qo, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss_n<KP>(ta, desc_k(tkw, kk), H::b_k(qs, qo, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(ta);

      const float* v = vec + s * L::kVecStage + hf * KP;
      uint32_t af[KP / 4], tf[KP / 4];
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(v + 8 * j + cq2);
        const float2 m2 =
            *reinterpret_cast<const float2*>(v + kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[2], pt[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            p[cc] = exp2f(fmaf(sa[r], kLog2e, b2[i]) - (cc ? l2.y : l2.x));
            pt[cc] = p[cc] * (ta[r] + tb[i] - (cc ? m2.y : m2.x));
          }
          af[2 * j + i] = pack_bf16(p[0], p[1]);
          tf[2 * j + i] = pack_bf16(pt[0], pt[1]);
        }
      }
      // ĝv += [Aᵀ | (A⊙(T − μ))ᵀ]·[ĝo ; ĝt]; ĝtv += Aᵀ·ĝt
      wgmma_fence();
      if (GO) {
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk)
          mma_rs_t(av, af + 4 * kk, H::b_mn(gos, slice, k16 + kk));
      }
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(av, tf + 4 * kk, H::b_mn(gts, slice, k16 + kk));
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(atv, af + 4 * kk, H::b_mn(gts, slice, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(av);
      fence_acc(atv);
    }
    mbar_arrive(bars.empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_blk + 8 * i;
    if (key >= nk) continue;
    const size_t off = (keys0 + key) * kD + 64 * slice;
    store_row(gv + off, av, i, 1.f);
    store_row(gtv + off, atv, i, 1.f);
  }
}

template <int DA, bool GO>
cudaError_t launch(const Maps& mp, const Rows& a, int bh,
                   __nv_bfloat16* gq, float* gk, __nv_bfloat16* gv,
                   float* gbias, __nv_bfloat16* gtq, float* gtk,
                   __nv_bfloat16* gtv, float* gtbias, cudaStream_t stream) {
  auto qk = hv_bwd_q_tc_kernel<DA, GO>;
  auto kk = hv_bwd_k_tc_kernel<DA, GO>;
  auto vk = hv_bwd_v_tc_kernel<DA, GO>;
  cudaError_t err = set_smem(qk, LQ<DA>::kBytes);
  if (err == cudaSuccess) err = set_smem(kk, LK<DA>::kBytes);
  if (err == cudaSuccess) err = set_smem(vk, LV<DA>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((a.nq + kBlockRows - 1) / kBlockRows * DA, bh);
  const dim3 kgrid((a.nk + kBlockRows - 1) / kBlockRows * DA, bh);
  qk<<<qgrid, kThreads, LQ<DA>::kBytes, stream>>>(mp, a, gq, gtq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kk<<<kgrid, kThreads, LK<DA>::kBytes, stream>>>(mp, a, gk, gtk, gbias,
                                                  gtbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vk<<<kgrid, kThreads, LV<DA>::kBytes, stream>>>(mp, a, gv, gtv);
  return cudaGetLastError();
}

// the maps at head dim 64·DA (boxes of Heads<DA>::kCols rows), then the
// three kernels
template <int DA>
cudaError_t run(const void* q, const void* k, const void* v, const void* tq,
                const void* tk, const void* tv, const void* go,
                const void* gt, const Rows& a, int bh, void* gq, void* gk,
                void* gv, void* gbias, void* gtq, void* gtk, void* gtv,
                void* gtbias, cudaStream_t s) {
  constexpr int kD = Heads<DA>::kD, kCols = Heads<DA>::kCols;
  const int nq = a.nq, nk = a.nk;
  Maps mp;
  cudaError_t err = make_map(&mp.q, q, bh, nq, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.tq, tq, bh, nq, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.gt, gt, bh, nq, kD, kCols);
  // without ĝo its map is never read: a copy of ĝt's stands in
  if (err == cudaSuccess)
    err = make_map(&mp.go, go ? go : gt, bh, nq, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.k, k, bh, nk, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.tk, tk, bh, nk, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.v, v, bh, nk, kD, kCols);
  if (err == cudaSuccess) err = make_map(&mp.tv, tv, bh, nk, kD, kCols);
  if (err != cudaSuccess) return err;
  auto bf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  auto f32 = [](void* p) { return static_cast<float*>(p); };
  if (go)
    return launch<DA, true>(mp, a, bh, bf(gq), f32(gk), bf(gv), f32(gbias),
                            bf(gtq), f32(gtk), bf(gtv), f32(gtbias), s);
  return launch<DA, false>(mp, a, bh, bf(gq), f32(gk), bf(gv), f32(gbias),
                           bf(gtq), f32(gtk), bf(gtv), f32(gtbias), s);
}

}  // namespace

// bf16 (bh, n, d) operands and cotangents, 16-byte aligned; bias, tbias
// (bh, nk) and lse (bh, nq) fp32.  `go` may be null (no cotangent on out).
// gq, gv, gtq, gtv are bf16; gk, gtk, gbias and gtbias fp32; `stats` is a
// (bh, nq, 3) fp32 workspace.  The dtype code must be 1 (bfloat16) and d
// 64 or 128.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_hv_bwd_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* tq, const void* tk, const void* tv, const void* tbias,
    const void* lse, const void* go, const void* gt, void* gq, void* gk,
    void* gv, void* gbias, void* gtq, void* gtk, void* gtv, void* gtbias,
    void* stats, int bh, int nq, int nk, int d, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || (d != 64 && d != 128) ||
      dtype != 1)
    return cudaErrorInvalidValue;
  const Rows a{static_cast<const float*>(bias), static_cast<const float*>(tbias),
               static_cast<const float*>(lse), static_cast<float*>(stats), nq,
               nk};
  auto fn = d == 64 ? run<1> : run<2>;
  return fn(q, k, v, tq, tk, tv, go, gt, a, bh, gq, gk, gv, gbias, gtq, gtk,
            gtv, gtbias, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
