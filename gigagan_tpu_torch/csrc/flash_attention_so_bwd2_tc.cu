// Adjoint of the fused-heads attention backward on Hopper's tensor cores
// (kernel K5, the bf16 route at head dim 64): the second derivative of
// softmax attention that the R1 penalty's double backward needs.
//
// Replaces the Pallas TPU kernel `_bwd2_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_so.py (called through
// `_bwd_so_bwd`), as flash_attention_so_bwd2.cu does on CUDA cores for
// fp32 and the other head dims.  The function is that file's (the math of
// ops/kernels/flash_attention_so.py): on K3's prepared operands q, k̂, v,
// bias, the null rows and K4's cotangent input g, given the cotangents Ã,
// B̃, C̃ (bf16, like q/k̂/v) and D̃, Ẽ, F̃, H̃ (fp32) of K4's outputs, per head
//
//   P = exp(q·k̂ᵀ + bias − lse)   dA = g·vᵀ   c_dS = [Ã | q]·[k̂ | B̃]ᵀ + D̃
//   δ = Σ P dA   r₁ = Σ P c_dS dA   r₂ = Σ P c_dS   r₃ = Σ P (g·C̃ᵀ)
//   ρ = r₁ + r₃ − 2δr₂   (the null column in every row sum)
//   dS = P (dA − δ)   c_dA = P (c_dS − r₂)
//   c_S = P (c_dS (dA − δ) − r₂ dA − ρ + g·C̃ᵀ)
//   c_q = [c_S | dS]·[k̂ ; B̃]   c_g = [c_dA | P]·[v ; C̃]
//   c_k̂ = [c_Sᵀ | dSᵀ]·[q ; Ã]   c_v = c_dAᵀ·g   c_bias = colsum(c_S)
//   plus the null token's rows and cotangents.
//
// What bounds it on an H100: 22 (n, n, d) products per (sample, head) in
// this design (12 are the minimum), operation-bound at the discriminator's
// R1 shapes (b·H = 512 at n = 1024, 1024 at n = 256).  Design, on K4-_tc's
// machinery (flash_attention_fused_bwd_tc.cu: a producer warp runs a TMA
// ring on mbarriers and stages per-tile rows; two consumer warpgroups of 64
// rows run `wgmma`):
//
// 1. `so2_q_tc_kernel`, query-major, one block per (128 queries, head,
//    sample).  q, g, Ã stay in shared memory; the key tiles of 64 (k̂, v,
//    B̃, C̃ with the bias and D̃ rows) stream through the ring twice.  Pass 1 forms
//    the row statistics (δ, r₂, ρ) from P, dA, c_dS and g·C̃ᵀ on the
//    fragment and writes them for step 2.  Pass 2 rebuilds the pieces and
//    accumulates c_q and c_g on `wgmma` with the pieces as A from registers
//    and k̂, B̃, v, C̃ read MN-major.  c_dS is one chain of K = 2d into one
//    accumulator; g·C̃ᵀ accumulates onto the finished c_S term, so the
//    pieces need no fourth fp32 tile.  The null column is done on CUDA
//    cores from the resident tiles; per-block null partials go to a
//    workspace.
// 2. `so2_k_tc_kernel`, key-major, one block per (128 keys, head, sample):
//    k̂, v, B̃, C̃ resident, q, g, Ã and the per-query rows (lse, δ, r₂, ρ)
//    streamed; it rebuilds the transposed pieces and accumulates c_k̂ and
//    c_v, and c_bias as fp32 row sums of the unrounded c_Sᵀ.
// 3. `null_reduce_kernel` (flash_attention_common.cuh): the null partials
//    added in a fixed order.  No float atomics: the result is deterministic.
//
// Registers: four (64 × 64) fp32 pieces and two (64 × d) accumulators would
// be 192 per consumer thread.  Here each 64-row streamed tile is rebuilt in
// two 32-column pieces (m64n32k16 products), and the pieces go to bf16
// fragments as soon as they are formed (dS, c_dA, then c_S and P).  A block
// is 288 threads (two consumer warpgroups and one producer warp); the
// register file's four quarters take three of its nine warps each, so
// ptxas allocates 168 registers a thread (224 compiles, but the launch is
// refused; `setmaxnreg` does not raise what ptxas allocates).  With
// 64-column pieces both kernels spilled ~500 bytes.

#include <math.h>

#include "flash_attention_common.cuh"
#include "hopper_tc.cuh"

namespace {

using namespace tc;

constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kBlockRows = 128;  // resident rows per block
constexpr int kCols = 64;        // rows of a streamed tile
constexpr int kD = 64;
constexpr int kTile = kAtomBytes;      // 64 rows × 64 bf16
constexpr int kRes = 2 * kAtomBytes;   // 128 rows
constexpr int kStages = 3;
// keys (query-major) or queries (key-major) per piece: a 64-row streamed
// tile is rebuilt in two 32-column halves, so the fp32 pieces take 16
// registers each (faster than 64-column pieces at D's R1 pair on an H100;
// PERF.md has the times)
constexpr int KP = 32;

// query-major: resident q, g, Ã; stages of k̂, v, B̃, C̃ + (bias, D̃) rows
struct LayoutQ {
  static constexpr int kRing = 3 * kRes;
  static constexpr int kStage = 4 * kTile;
  static constexpr int kVec = kRing + kStages * kStage;
  static constexpr int kNull = kVec + kStages * 2 * kCols * 4;
  static constexpr int kBars = kNull + 3 * kBlockRows * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// key-major: resident k̂, v, B̃, C̃; stages of q, g, Ã + (lse, δ, r₂, ρ)
struct LayoutK {
  static constexpr int kRing = 4 * kRes;
  static constexpr int kStage = 3 * kTile;
  static constexpr int kVec = kRing + kStages * kStage;
  static constexpr int kBars = kVec + kStages * 4 * kCols * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 32);
      mbar_init(bars + 8 * (1 + kStages + s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// Σ over 8 columns of x ⊙ y, x a chunk of bf16, y 8 fp32 in global memory
__device__ __forceinline__ float dot8f(uint4 x, const float* y) {
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xa[i]);
    s = fmaf(a.x, y[2 * i], fmaf(a.y, y[2 * i + 1], s));
  }
  return s;
}

// The producer warp: `nres` resident 128-row tiles from `res` (row r0),
// then per ring step the `nstr` 64-row tiles of `str` at row 64·(t % ntiles),
// `fill(s, t)` staging the step's per-tile rows before the warp arrives.
template <int NRES, int NSTR, typename Fill>
__device__ __forceinline__ void produce(uint32_t base, uint32_t bars,
                                        const CUtensorMap* const* res,
                                        const CUtensorMap* const* str,
                                        int col, int r0, int bi, int steps,
                                        int ntiles, int ring, int stage,
                                        Fill fill) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_tx(bars, NRES * kRes);
    for (int m = 0; m < NRES; ++m)
      for (int wg = 0; wg < 2; ++wg)
        tma_load(base + m * kRes + wg * kAtomBytes, res[m], bars, col,
                 r0 + 64 * wg, bi);
  }
  for (int t = 0; t < steps; ++t) {
    const int s = t % kStages;
    const uint32_t full = bars + 8 * (1 + s);
    if (t >= kStages)
      mbar_wait(bars + 8 * (1 + kStages + s), ((t / kStages) - 1) & 1);
    fill(s, t % ntiles);
    if (lane == 0) {
      mbar_arrive_tx(full, NSTR * kTile);
      const uint32_t st = base + ring + s * stage;
      for (int m = 0; m < NSTR; ++m)
        tma_load(st + m * kTile, str[m], full, col, (t % ntiles) * kCols, bi);
    } else {
      mbar_arrive(full);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
so2_q_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ nullk,
                const __nv_bfloat16* __restrict__ nullv,
                const float* __restrict__ null_bias,
                const float* __restrict__ lse,
                const float* __restrict__ cdbias,
                const float* __restrict__ ce, const float* __restrict__ cf,
                const float* __restrict__ ch,
                __nv_bfloat16* __restrict__ cq, __nv_bfloat16* __restrict__ cg,
                float* __restrict__ stats, float* __restrict__ null_part,
                int nq, int nk, int heads, int have_null) {
  using L = LayoutQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  float* null_cs = reinterpret_cast<float*>(smem + L::kNull);  // c_Sⁿ
  float* null_ds = null_cs + kBlockRows;                        // dSⁿ
  float* null_ca = null_ds + kBlockRows;                        // c_dAⁿ
  const uint32_t bars = base + L::kBars;
  init_bars(bars);

  const int q0 = blockIdx.x * kBlockRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int ntiles = (nk + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t keys0 = ((size_t)bi * heads + hh) * nk;

  if (warp == kConsumers / 32) {
    const CUtensorMap* res[3] = {&qmap, &gmap, &amap};
    const CUtensorMap* str[4] = {&kmap, &vmap, &bmap, &cmap};
    produce<3, 4>(base, bars, res, str, hh * kD, q0, bi, 2 * ntiles, ntiles,
                  L::kRing, L::kStage, [&](int s, int t) {
                    for (int c = lane; c < kCols; c += 32) {
                      const int key = t * kCols + c;
                      const bool ok = key < nk;
                      vec[s * 2 * kCols + c] =
                          ok ? (bias ? bias[keys0 + key] * kLog2e : 0.f)
                             : -INFINITY;
                      vec[s * 2 * kCols + kCols + c] =
                          ok && cdbias ? cdbias[keys0 + key] : 0.f;
                    }
                  });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint8_t* q_tile = smem;
  const uint8_t* g_tile = smem + kRes;
  const uint8_t* a_tile = smem + 2 * kRes;
  const uint32_t qw = base + wg * kAtomBytes;
  const uint32_t gw = base + kRes + wg * kAtomBytes;
  const uint32_t aw = base + 2 * kRes + wg * kAtomBytes;
  const size_t hd = (size_t)heads * kD;
  const size_t rows0 = ((size_t)bi * heads + hh) * nq;

  // the null column, per row (the quad shares a row)
  float lse2[2], pn[2], dan[2], cdsn[2], gfn[2];
  mbar_wait(bars, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rb = row_blk + 8 * i;
    const bool valid = q0 + rb < nq;
    lse2[i] = valid ? lse[rows0 + q0 + rb] * kLog2e : INFINITY;
    pn[i] = dan[i] = cdsn[i] = gfn[i] = 0.f;
    if (have_null) {
      const __nv_bfloat16* nk_h = nullk + (size_t)hh * kD;
      const __nv_bfloat16* nv_h = nullv + (size_t)hh * kD;
      const float* e_h = ce + (size_t)hh * kD;
      const float* f_h = cf + (size_t)hh * kD;
      float sn = 0.f, an = 0.f, cn = 0.f, fn = 0.f;
      for (int c8 = lane % 4; c8 < kD / 8; c8 += 4) {
        const uint4 qc = tile_chunk<1>(q_tile, rb, c8);
        const uint4 gc = tile_chunk<1>(g_tile, rb, c8);
        sn += dot8(qc, nk_h + 8 * c8);
        an += dot8(gc, nv_h + 8 * c8);
        cn += dot8(tile_chunk<1>(a_tile, rb, c8), nk_h + 8 * c8) +
              dot8f(qc, e_h + 8 * c8);
        fn += dot8f(gc, f_h + 8 * c8);
      }
      sn = quad_sum(sn);
      pn[i] = valid ? exp2f((sn + null_bias[hh]) * kLog2e - lse2[i]) : 0.f;
      dan[i] = quad_sum(an);
      cdsn[i] = quad_sum(cn) + ch[hh];
      gfn[i] = quad_sum(fn);
    }
  }

  // ---- pass 1: row statistics
  float r1[2] = {0.f, 0.f}, r2[2] = {0.f, 0.f}, r3[2] = {0.f, 0.f},
        r4[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * (1 + s), (t / kStages) & 1);
    const uint32_t ks = base + L::kRing + s * L::kStage;
    const uint32_t vs = ks + kTile, bs = ks + 2 * kTile, cs = ks + 3 * kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t ko = hf * KP * 128;  // the piece's first key row
      float sa[KP / 2], da[KP / 2], xa[KP / 2], ya[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n<KP>(sa, desc_k(qw, kk), desc_k(ks + ko, kk), kk > 0);
        mma_ss_n<KP>(da, desc_k(gw, kk), desc_k(vs + ko, kk), kk > 0);
        mma_ss_n<KP>(ya, desc_k(gw, kk), desc_k(cs + ko, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(aw, kk), desc_k(ks + ko, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(qw, kk), desc_k(bs + ko, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(da);
      fence_acc(xa);
      fence_acc(ya);
      const float* bv = vec + s * 2 * kCols + hf * KP;
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq2);
        const float2 d2 =
            *reinterpret_cast<const float2*>(bv + kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, c ? b2.y : b2.x) - lse2[i]);
            const float pc = p * (xa[r] + (c ? d2.y : d2.x));
            r4[i] = fmaf(p, da[r], r4[i]);
            r1[i] = fmaf(pc, da[r], r1[i]);
            r2[i] += pc;
            r3[i] = fmaf(p, ya[r], r3[i]);
          }
      }
    }
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }
  float del[2], rho[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    del[i] = quad_sum(r4[i]) + pn[i] * dan[i];
    const float s1 = quad_sum(r1[i]) + pn[i] * cdsn[i] * dan[i];
    r2[i] = quad_sum(r2[i]) + pn[i] * cdsn[i];
    const float s3 = quad_sum(r3[i]) + pn[i] * gfn[i];
    rho[i] = s1 + s3 - 2.f * del[i] * r2[i];
    const int row = q0 + row_blk + 8 * i;
    if (row < nq && lane % 4 == 0) {
      float* st = stats + (rows0 + row) * 3;
      st[0] = del[i];
      st[1] = r2[i];
      st[2] = rho[i];
    }
  }

  // ---- pass 2: c_q and c_g, seeded with the null column's terms
  float acq[32], acg[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float dsn = pn[i] * (dan[i] - del[i]);
    const float c_dan = pn[i] * (cdsn[i] - r2[i]);
    const float c_sn = pn[i] * (cdsn[i] * (dan[i] - del[i]) + gfn[i] -
                                r2[i] * dan[i] - rho[i]);
    if (lane % 4 == 0) {
      null_cs[row_blk + 8 * i] = c_sn;
      null_ds[row_blk + 8 * i] = dsn;
      null_ca[row_blk + 8 * i] = c_dan;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 4 * j + 2 * i + c;
        const int col = 8 * j + cq2 + c;
        acq[r] = acg[r] = 0.f;
        if (have_null) {
          acq[r] = c_sn * __bfloat162float(nullk[(size_t)hh * kD + col]) +
                   dsn * ce[(size_t)hh * kD + col];
          acg[r] = c_dan * __bfloat162float(nullv[(size_t)hh * kD + col]) +
                   pn[i] * cf[(size_t)hh * kD + col];
        }
      }
  }
  for (int t = ntiles; t < 2 * ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * (1 + s), (t / kStages) & 1);
    const uint32_t ks = base + L::kRing + s * L::kStage;
    const uint32_t vs = ks + kTile, bs = ks + 2 * kTile, cs = ks + 3 * kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t ko = hf * KP * 128;
      const int k16 = hf * KP / 16;  // the piece's first 16-key step
      float sa[KP / 2], da[KP / 2], xa[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n<KP>(sa, desc_k(qw, kk), desc_k(ks + ko, kk), kk > 0);
        mma_ss_n<KP>(da, desc_k(gw, kk), desc_k(vs + ko, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(aw, kk), desc_k(ks + ko, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(qw, kk), desc_k(bs + ko, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(da);
      fence_acc(xa);

      // P stays fp32 in sa; dS and c_dA go to fragments; xa becomes
      // c_dS (dA − δ) − r₂ dA − ρ
      uint32_t df[KP / 4], cf_[KP / 4];
      const float* bv = vec + s * 2 * kCols + hf * KP;
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq2);
        const float2 d2 =
            *reinterpret_cast<const float2*>(bv + kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ds[2], cda[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, c ? b2.y : b2.x) - lse2[i]);
            const float cds = xa[r] + (c ? d2.y : d2.x);
            const float dm = da[r] - del[i];
            ds[c] = p * dm;
            cda[c] = p * (cds - r2[i]);
            xa[r] = cds * dm - r2[i] * da[r] - rho[i];
            sa[r] = p;
          }
          df[2 * j + i] = pack_bf16(ds[0], ds[1]);
          cf_[2 * j + i] = pack_bf16(cda[0], cda[1]);
        }
      }
      // g·C̃ᵀ onto the c_S term; c_q += dS·B̃, c_g += c_dA·v
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(gw, kk), desc_k(cs + ko, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        mma_rs_t(acq, df + 4 * kk, desc_mn(bs, 0, k16 + kk));
        mma_rs_t(acg, cf_ + 4 * kk, desc_mn(vs, 0, k16 + kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(xa);
      fence_acc(acq);
      fence_acc(acg);
      uint32_t sf[KP / 4], pf[KP / 4];
#pragma unroll
      for (int r = 0; r < KP / 4; ++r) {
        sf[r] =
            pack_bf16(sa[2 * r] * xa[2 * r], sa[2 * r + 1] * xa[2 * r + 1]);
        pf[r] = pack_bf16(sa[2 * r], sa[2 * r + 1]);
      }
      // c_q += c_S·k̂, c_g += P·C̃
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        mma_rs_t(acq, sf + 4 * kk, desc_mn(ks, 0, k16 + kk));
        mma_rs_t(acg, pf + 4 * kk, desc_mn(cs, 0, k16 + kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acq);
      fence_acc(acg);
    }
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_blk + 8 * i;
    if (row >= nq) continue;
    const size_t off = ((size_t)bi * nq + row) * hd + hh * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq2;
      *reinterpret_cast<__nv_bfloat162*>(cq + off + col) =
          __floats2bfloat162_rn(acq[4 * j + 2 * i], acq[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(cg + off + col) =
          __floats2bfloat162_rn(acg[4 * j + 2 * i], acg[4 * j + 2 * i + 1]);
    }
  }

  if (have_null) {
    // this block's partials of the null cotangents, rows in order
    consumer_sync(kConsumers);
    const int tid = threadIdx.x;
    float* part = null_part +
                  (((size_t)bi * gridDim.x + blockIdx.x) * heads + hh) *
                      (2 * kD + 1);
    if (tid < kD) {
      float sk = 0.f;
      for (int r = 0; r < kBlockRows; ++r)
        sk += null_cs[r] * tile_at(q_tile, 1, r, tid) +
              null_ds[r] * tile_at(a_tile, 1, r, tid);
      part[tid] = sk;
    } else if (tid >= 128 && tid < 128 + kD) {
      float sv = 0.f;
      for (int r = 0; r < kBlockRows; ++r)
        sv += null_ca[r] * tile_at(g_tile, 1, r, tid - 128);
      part[kD + tid - 128] = sv;
    }
    if (tid == kConsumers - 1) {
      float sb = 0.f;
      for (int r = 0; r < kBlockRows; ++r) sb += null_cs[r];
      part[2 * kD] = sb;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
so2_k_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ cdbias,
                const float* __restrict__ stats,
                __nv_bfloat16* __restrict__ ck, __nv_bfloat16* __restrict__ cv,
                float* __restrict__ cbias, int nq, int nk, int heads) {
  using L = LayoutK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const uint32_t bars = base + L::kBars;
  init_bars(bars);

  const int k0 = blockIdx.x * kBlockRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int ntiles = (nq + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t rows0 = ((size_t)bi * heads + hh) * nq;
  const size_t keys0 = ((size_t)bi * heads + hh) * nk;

  if (warp == kConsumers / 32) {
    // per query: lse in the log2 domain (+inf past nq: P = 0), δ, r₂, ρ
    const CUtensorMap* res[4] = {&kmap, &vmap, &bmap, &cmap};
    const CUtensorMap* str[3] = {&qmap, &gmap, &amap};
    produce<4, 3>(base, bars, res, str, hh * kD, k0, bi, ntiles, ntiles,
                  L::kRing, L::kStage, [&](int s, int t) {
                    float* v = vec + s * 4 * kCols;
                    for (int c = lane; c < kCols; c += 32) {
                      const int qr = t * kCols + c;
                      const bool ok = qr < nq;
                      const float* st = stats + (rows0 + qr) * 3;
                      v[c] = ok ? lse[rows0 + qr] * kLog2e : INFINITY;
                      v[kCols + c] = ok ? st[0] : 0.f;
                      v[2 * kCols + c] = ok ? st[1] : 0.f;
                      v[3 * kCols + c] = ok ? st[2] : 0.f;
                    }
                  });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint32_t kw = base + wg * kAtomBytes;
  const uint32_t vw = base + kRes + wg * kAtomBytes;
  const uint32_t bw = base + 2 * kRes + wg * kAtomBytes;
  const uint32_t cw = base + 3 * kRes + wg * kAtomBytes;

  float b2[2], dt[2], cb_sum[2], ack[32], acv[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_blk + 8 * i;
    const bool ok = key < nk;
    b2[i] = ok ? (bias ? bias[keys0 + key] * kLog2e : 0.f) : -INFINITY;
    dt[i] = ok && cdbias ? cdbias[keys0 + key] : 0.f;
    cb_sum[i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 32; ++r) ack[r] = acv[r] = 0.f;
  mbar_wait(bars, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * (1 + s), (t / kStages) & 1);
    const uint32_t qs = base + L::kRing + s * L::kStage;
    const uint32_t gs = qs + kTile, as = qs + 2 * kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      // rows are keys, columns the queries KP·hf .. of the tile
      const uint32_t qo = hf * KP * 128;
      const int k16 = hf * KP / 16;
      float sa[KP / 2], da[KP / 2], xa[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n<KP>(sa, desc_k(kw, kk), desc_k(qs + qo, kk), kk > 0);
        mma_ss_n<KP>(da, desc_k(vw, kk), desc_k(gs + qo, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(kw, kk), desc_k(as + qo, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(bw, kk), desc_k(qs + qo, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(da);
      fence_acc(xa);

      const float* v = vec + s * 4 * kCols + hf * KP;
      uint32_t df[KP / 4], cf_[KP / 4];
#pragma unroll
      for (int j = 0; j < KP / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(v + 8 * j + cq2);
        const float2 dl =
            *reinterpret_cast<const float2*>(v + kCols + 8 * j + cq2);
        const float2 q2 =
            *reinterpret_cast<const float2*>(v + 2 * kCols + 8 * j + cq2);
        const float2 rh =
            *reinterpret_cast<const float2*>(v + 3 * kCols + 8 * j + cq2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ds[2], cda[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            const float p =
                exp2f(fmaf(sa[r], kLog2e, b2[i]) - (c ? l2.y : l2.x));
            const float cds = xa[r] + dt[i];
            const float r2c = c ? q2.y : q2.x;
            const float dm = da[r] - (c ? dl.y : dl.x);
            ds[c] = p * dm;
            cda[c] = p * (cds - r2c);
            xa[r] = cds * dm - r2c * da[r] - (c ? rh.y : rh.x);
            sa[r] = p;
          }
          df[2 * j + i] = pack_bf16(ds[0], ds[1]);
          cf_[2 * j + i] = pack_bf16(cda[0], cda[1]);
        }
      }
      // (g·C̃ᵀ)ᵀ onto the c_Sᵀ term; c_k̂ += dSᵀ·Ã, c_v += c_dAᵀ·g
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(xa, desc_k(cw, kk), desc_k(gs + qo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        mma_rs_t(ack, df + 4 * kk, desc_mn(as, 0, k16 + kk));
        mma_rs_t(acv, cf_ + 4 * kk, desc_mn(gs, 0, k16 + kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(xa);
      fence_acc(ack);
      fence_acc(acv);
      uint32_t sf[KP / 4];
#pragma unroll
      for (int r = 0; r < KP / 4; ++r) {
        const float c0 = sa[2 * r] * xa[2 * r];
        const float c1 = sa[2 * r + 1] * xa[2 * r + 1];
        cb_sum[r % 2] += c0 + c1;  // row i = r % 2; unrounded, as the plain
        sf[r] = pack_bf16(c0, c1);
      }
      // c_k̂ += c_Sᵀ·q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(ack, sf + 4 * kk, desc_mn(qs, 0, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(ack);
    }
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  const size_t hd = (size_t)heads * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float colsum = quad_sum(cb_sum[i]);
    const int key = k0 + row_blk + 8 * i;
    if (key >= nk) continue;
    const size_t off = ((size_t)bi * nk + key) * hd + hh * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq2;
      *reinterpret_cast<__nv_bfloat162*>(ck + off + col) =
          __floats2bfloat162_rn(ack[4 * j + 2 * i], ack[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(cv + off + col) =
          __floats2bfloat162_rn(acv[4 * j + 2 * i], acv[4 * j + 2 * i + 1]);
    }
    if (cbias && lane % 4 == 0) cbias[keys0 + key] = colsum;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *g, *cdq, *cdk, *cdv;
  const float *bias, *null_bias, *lse, *cdbias, *ce, *cf, *ch;
  const __nv_bfloat16 *nullk, *nullv;
  __nv_bfloat16 *cq, *ck, *cv, *cg;
  float *cbias, *stats, *null_part, *cnk, *cnv, *cnb;
  int b, nq, nk, heads, have_null;
};

cudaError_t launch(const Args& a, cudaStream_t s) {
  const int hd = a.heads * kD;
  CUtensorMap qm, km, vm, gm, am, bm, cm;
  cudaError_t err = make_map(&qm, a.q, a.b, a.nq, hd);
  if (err == cudaSuccess) err = make_map(&km, a.k, a.b, a.nk, hd);
  if (err == cudaSuccess) err = make_map(&vm, a.v, a.b, a.nk, hd);
  if (err == cudaSuccess) err = make_map(&gm, a.g, a.b, a.nq, hd);
  if (err == cudaSuccess) err = make_map(&am, a.cdq, a.b, a.nq, hd);
  if (err == cudaSuccess) err = make_map(&bm, a.cdk, a.b, a.nk, hd);
  if (err == cudaSuccess) err = make_map(&cm, a.cdv, a.b, a.nk, hd);
  auto qk = so2_q_tc_kernel;
  auto kk = so2_k_tc_kernel;
  if (err == cudaSuccess) err = set_smem(qk, LayoutQ::kBytes);
  if (err == cudaSuccess) err = set_smem(kk, LayoutK::kBytes);
  if (err != cudaSuccess) return err;
  const int qblocks = (a.nq + kBlockRows - 1) / kBlockRows;
  qk<<<dim3(qblocks, a.heads, a.b), kThreads, LayoutQ::kBytes, s>>>(
      qm, km, vm, gm, am, bm, cm, a.bias, a.nullk, a.nullv, a.null_bias,
      a.lse, a.cdbias, a.ce, a.cf, a.ch, a.cq, a.cg, a.stats, a.null_part,
      a.nq, a.nk, a.heads, a.have_null);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kk<<<dim3((a.nk + kBlockRows - 1) / kBlockRows, a.heads, a.b), kThreads,
       LayoutK::kBytes, s>>>(qm, km, vm, gm, am, bm, cm, a.bias, a.lse,
                             a.cdbias, a.stats, a.ck, a.cv, a.cbias, a.nq,
                             a.nk, a.heads);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.have_null) return err;
  flash::null_reduce_kernel<<<a.heads, flash::kThreads, 0, s>>>(
      a.null_part, a.cnk, a.cnv, a.cnb, a.b * qblocks, a.heads, kD);
  return cudaGetLastError();
}

}  // namespace

// bf16 operands at head dim 64, every (b, n, H·d) pointer 16-byte aligned.
// `bias`, `cdbias` and `cbias` are (b, H, nk) fp32 or all null; the
// null-token operands (nullk/nullv bf16 (H, 64), null_bias and the
// cotangents cdnullk/cdnullv (H, 64) and cdnull_bias (H,) fp32) and the
// null outputs may be null when have_null is 0.  `stats` is a (b, H, nq, 3)
// fp32 workspace, `null_part` one of at least b·ceil(nq/128)·H·129 floats.
// Returns a cudaError_t.
extern "C" int gigagan_flash_attention_so_bwd2_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias,
    const void* g, const void* lse, const void* cdq, const void* cdk,
    const void* cdv, const void* cdbias, const void* cdnullk,
    const void* cdnullv, const void* cdnull_bias, void* cq, void* ck,
    void* cv, void* cg, void* cbias, void* stats, void* null_part,
    void* cnullk, void* cnullv, void* cnull_bias, int b, int nq, int nk,
    int heads, int d, int have_null, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || d != kD || (bias == nullptr) != (cbias == nullptr) ||
      (have_null &&
       (nullk == nullptr || nullv == nullptr || null_bias == nullptr ||
        cdnullk == nullptr || cdnullv == nullptr || cdnull_bias == nullptr ||
        null_part == nullptr || cnullk == nullptr || cnullv == nullptr ||
        cnull_bias == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.cdq = cdq;
  a.cdk = cdk;
  a.cdv = cdv;
  a.bias = static_cast<const float*>(bias);
  a.null_bias = static_cast<const float*>(null_bias);
  a.lse = static_cast<const float*>(lse);
  a.cdbias = static_cast<const float*>(cdbias);
  a.ce = static_cast<const float*>(cdnullk);
  a.cf = static_cast<const float*>(cdnullv);
  a.ch = static_cast<const float*>(cdnull_bias);
  a.nullk = static_cast<const __nv_bfloat16*>(nullk);
  a.nullv = static_cast<const __nv_bfloat16*>(nullv);
  a.cq = static_cast<__nv_bfloat16*>(cq);
  a.ck = static_cast<__nv_bfloat16*>(ck);
  a.cv = static_cast<__nv_bfloat16*>(cv);
  a.cg = static_cast<__nv_bfloat16*>(cg);
  a.cbias = static_cast<float*>(cbias);
  a.stats = static_cast<float*>(stats);
  a.null_part = static_cast<float*>(null_part);
  a.cnk = static_cast<float*>(cnullk);
  a.cnv = static_cast<float*>(cnullv);
  a.cnb = static_cast<float*>(cnull_bias);
  a.b = b;
  a.nq = nq;
  a.nk = nk;
  a.heads = heads;
  a.have_null = have_null;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(a, s);
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
