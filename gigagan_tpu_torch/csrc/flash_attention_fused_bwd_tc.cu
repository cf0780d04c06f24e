// Fused-heads attention backward from the saved log-sum-exp on Hopper's
// tensor cores (kernel K4, the bf16 route for head dims 64 and 128).
//
// Replaces the Pallas TPU kernel `_bwd_sc_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_so.py (called through
// `_bwd_sc_impl`), as flash_attention_fused_bwd.cu does on CUDA cores for
// the other cases.  The function is that file's: on K3's PREPARED operands,
// with the cotangent g, K3's out and its lse, per head
//
//   P = exp(q·k_preᵀ + bias − lse)     Pⁿ = exp(q·nullk_pre + null_bias − lse)
//   dA = g·vᵀ   δ = rowsum(g ⊙ out)   dS = P ⊙ (dA − δ)   dSⁿ = Pⁿ (g·nullv − δ)
//   dq = dS·k_pre + dSⁿ nullk_pre      dk_pre = dSᵀ·q     dv = Pᵀ·g
//   dbias = colsum(dS)   and, summed over batch and rows,
//   dnullk_pre = Σ dSⁿ q   dnullv = Σ Pⁿ g   dnull_bias = Σ dSⁿ
//
// What bounds it on an H100: 10·n²·d FLOPs per (sample, head) (five
// products) against ~8·n·d bytes, compute-bound at the discriminator's
// shapes (~0.35 ms of bf16 tensor-core work for the d_step's b·H = 512 at
// n = 1024).  Design: flash_attention_fused_bwd.cu's deterministic
// FlashAttention-2 split, no float atomics, each kernel shaped as K3's
// tensor-core forward (one producer warpgroup whose one warp runs a TMA
// ring on mbarriers and stages the per-tile rows; two consumer warpgroups
// of 64 rows on `wgmma`, `setmaxnreg` moving the registers to them):
//
// 1. `bwd_dq_tc_kernel`, query-major, one block per (128 queries, head,
//    sample): Q and G stay in shared memory; it forms δ (written out for
//    step 2) and the null column on CUDA cores, then per 64-key tile
//    S = Q·K̂ᵀ and dA = G·Vᵀ (both operands K-major), P and dS on the
//    fragment, dq += dS·K̂ with dS rounded to bf16 from registers and K̂
//    MN-major.  Per-block partials of the null gradients go to a workspace.
// 2. `bwd_dkdv_tc_kernel`, key-major, one block per (128 keys, head,
//    sample): K̂ and V stay in shared memory, Q, G, lse and δ stream
//    through the ring; per 64-query tile Sᵀ = K̂·Qᵀ and dAᵀ = V·Gᵀ, then
//    dV += Pᵀ·G and dK̂ += dSᵀ·Q from registers with B MN-major, and dbias
//    takes the fp32 row sums of the unrounded dSᵀ.
// 3. `null_reduce_kernel` (flash_attention_common.cuh): the null partials
//    added in a fixed order.
//
// The same kernels are K6b's bf16 route for head dims 64 and 128 (the
// split-heads backward, replacing `_bwd_kernel` of
// gigagan_tpu/ops/pallas/flash_attention.py, called through `_flash_bwd`):
// K6a's (b·h, n, d) operands with H = 1, b = b·h and no null token; dbias is
// its fourth output.  A masked key's bias and an all-masked row's lse
// (both NEG_INF) go to the log2 domain through `to_log2`, as in the forward,
// so such a row gives P = 1 at every key from its lse, as the plain version
// does.

#include <math.h>

#include "flash_attention_common.cuh"
#include "hopper_tc.cuh"

namespace {

using namespace tc;

constexpr int kConsumers = 256;
constexpr int kThreads = 384;
constexpr int kBlockRows = 128;  // rows of the resident tiles per block
constexpr int kCols = 64;        // rows of a streamed tile

template <int DA>
struct Layout {
  static constexpr int kStages = DA == 1 ? 4 : 3;
  static constexpr int kTile = DA * kAtomBytes;              // 64 rows
  static constexpr int kRes = 2 * kTile;                     // 128 rows
  static constexpr int kRing = 2 * kRes;                     // after 2 resident
  static constexpr int kStage = 2 * kTile;                   // 2 streamed tiles
  static constexpr int kVec = kRing + kStages * kStage;      // per-tile rows
  static constexpr int kNull = kVec + kStages * 2 * kCols * 4;
  static constexpr int kBars = kNull + 2 * kBlockRows * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

struct Bars {
  uint32_t res;
  uint32_t first;
  int stages;
  __device__ uint32_t full(int s) const { return first + 8 * s; }
  __device__ uint32_t empty(int s) const { return first + 8 * (stages + s); }
};

template <int DA>
__device__ __forceinline__ Bars init_bars(uint32_t base) {
  constexpr int S = Layout<DA>::kStages;
  Bars b{base + Layout<DA>::kBars, base + Layout<DA>::kBars + 8, S};
  if (threadIdx.x == 0) {
    mbar_init(b.res, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(b.full(s), 32);
      mbar_init(b.empty(s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return b;
}

// The producer warp: both resident 128-row tiles of operands a and b, then
// per ring stage the 64-row tiles of operands c and d with `fill(s, t)`
// writing the stage's per-tile rows before the warp arrives.
template <int DA, typename Fill>
__device__ __forceinline__ void produce(
    const Bars& bars, uint32_t base, const CUtensorMap* a,
    const CUtensorMap* b, const CUtensorMap* c, const CUtensorMap* d,
    int col, int r0, int bi, int ntiles, Fill fill) {
  using L = Layout<DA>;
  constexpr int S = L::kStages;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_tx(bars.res, 2 * L::kRes);
    for (int wg = 0; wg < 2; ++wg)
      for (int at = 0; at < DA; ++at) {
        const uint32_t off = (wg * DA + at) * kAtomBytes;
        tma_load(base + off, a, bars.res, col + 64 * at, r0 + 64 * wg, bi);
        tma_load(base + L::kRes + off, b, bars.res, col + 64 * at,
                 r0 + 64 * wg, bi);
      }
  }
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    if (t >= S) mbar_wait(bars.empty(s), ((t / S) - 1) & 1);
    fill(s, t);
    if (lane == 0) {
      mbar_arrive_tx(bars.full(s), L::kStage);
      const uint32_t st = base + L::kRing + s * L::kStage;
      for (int at = 0; at < DA; ++at) {
        tma_load(st + at * kAtomBytes, c, bars.full(s), col + 64 * at,
                 t * kCols, bi);
        tma_load(st + L::kTile + at * kAtomBytes, d, bars.full(s),
                 col + 64 * at, t * kCols, bi);
      }
    } else {
      mbar_arrive(bars.full(s));
    }
  }
}

template <int DA>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ nullk,
                 const __nv_bfloat16* __restrict__ nullv,
                 const float* __restrict__ null_bias,
                 const __nv_bfloat16* __restrict__ out,
                 const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                 float* __restrict__ delta, float* __restrict__ null_part,
                 int nq, int nk, int heads, int have_null) {
  using L = Layout<DA>;
  constexpr int D = 64 * DA;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  float* null_pn = reinterpret_cast<float*>(smem + L::kNull);
  float* null_ds = null_pn + kBlockRows;
  const Bars bars = init_bars<DA>(base);

  const int q0 = blockIdx.x * kBlockRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int ntiles = (nk + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<40>();
    if (warp == kConsumers / 32) {
      const float* bias_b =
          bias ? bias + ((size_t)bi * heads + hh) * nk : nullptr;
      produce<DA>(bars, base, &qmap, &gmap, &kmap, &vmap, hh * D, q0, bi,
                  ntiles, [&](int s, int t) {
                    for (int c = lane; c < kCols; c += 32) {
                      const int key = t * kCols + c;
                      vec[s * kCols + c] =
                          key < nk ? (bias_b ? to_log2(bias_b[key]) : 0.f)
                                   : -INFINITY;
                    }
                  });
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = warp / 4;
    const int r_lo = (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int row_blk = 64 * wg + r_lo;
    const uint8_t* q_tile = smem;
    const uint8_t* g_tile = smem + L::kRes;
    const uint32_t qw = base + wg * DA * kAtomBytes;
    const uint32_t gw = base + L::kRes + wg * DA * kAtomBytes;
    const size_t hd = (size_t)heads * D;
    const size_t rows0 = ((size_t)bi * heads + hh) * nq;

    float lse2[2], del[2], acc[DA][32];
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[a][r] = 0.f;
    mbar_wait(bars.res, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rb = row_blk + 8 * i;
      const int row = q0 + rb;
      const bool valid = row < nq;
      lse2[i] = valid ? to_log2(lse[rows0 + row]) : INFINITY;  // P = 0
      const __nv_bfloat16* orow = out + ((size_t)bi * nq + row) * hd + hh * D;
      float part = 0.f;
      if (valid)
        for (int ch = lane % 4; ch < D / 8; ch += 4)
          part += dot8(tile_chunk<DA>(g_tile, rb, ch), orow + 8 * ch);
      del[i] = quad_sum(part);
      if (valid && lane % 4 == 0) delta[rows0 + row] = del[i];
      if (have_null) {
        const __nv_bfloat16* nk_h = nullk + (size_t)hh * D;
        const __nv_bfloat16* nv_h = nullv + (size_t)hh * D;
        float sn = 0.f, dan = 0.f;
        for (int ch = lane % 4; ch < D / 8; ch += 4) {
          sn += dot8(tile_chunk<DA>(q_tile, rb, ch), nk_h + 8 * ch);
          dan += dot8(tile_chunk<DA>(g_tile, rb, ch), nv_h + 8 * ch);
        }
        sn = quad_sum(sn);
        dan = quad_sum(dan);
        const float pn = exp2f((sn + null_bias[hh]) * kLog2e - lse2[i]);
        const float dsn = pn * (dan - del[i]);
        if (lane % 4 == 0) {
          null_pn[rb] = pn;
          null_ds[rb] = dsn;
        }
#pragma unroll
        for (int a = 0; a < DA; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 nkv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(nk_h + 64 * a +
                                                         8 * j + cq));
            acc[a][4 * j + 2 * i] = dsn * nkv.x;
            acc[a][4 * j + 2 * i + 1] = dsn * nkv.y;
          }
      }
    }

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      mbar_wait(bars.full(s), (t / S) & 1);
      const uint32_t ks = base + L::kRing + s * L::kStage;
      const uint32_t vs = ks + L::kTile;

      float sacc[32], dacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss(sacc, desc_k(qw, kk), desc_k(ks, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss(dacc, desc_k(gw, kk), desc_k(vs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sacc);
      fence_acc(dacc);

      const float* bv = vec + s * kCols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            const float p =
                exp2f(fmaf(sacc[r], kLog2e, c ? b2.y : b2.x) - lse2[i]);
            sacc[r] = p * (dacc[r] - del[i]);  // dS
          }
      }
      uint32_t df[16];
      to_frags(sacc, df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < DA; ++a)
          mma_rs_t(acc[a], df + 4 * kk, desc_mn(ks, a, kk));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int a = 0; a < DA; ++a) fence_acc(acc[a]);
      mbar_arrive(bars.empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row_blk + 8 * i;
      if (row >= nq) continue;
      __nv_bfloat16* drow = dq + ((size_t)bi * nq + row) * hd + hh * D;
#pragma unroll
      for (int a = 0; a < DA; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(drow + 64 * a + 8 * j + cq) =
              __floats2bfloat162_rn(acc[a][4 * j + 2 * i],
                                    acc[a][4 * j + 2 * i + 1]);
    }

    if (have_null) {
      // this block's partials of the null gradients, rows in order
      consumer_sync(kConsumers);
      const int tid = threadIdx.x;
      float* part = null_part +
                    (((size_t)bi * gridDim.x + blockIdx.x) * heads + hh) *
                        (2 * D + 1);
      if (tid < D) {
        float sk = 0.f;
        for (int r = 0; r < kBlockRows; ++r)
          sk += null_ds[r] * tile_at(q_tile, DA, r, tid);
        part[tid] = sk;
      } else if (tid >= 128 && tid < 128 + D) {
        float sv = 0.f;
        for (int r = 0; r < kBlockRows; ++r)
          sv += null_pn[r] * tile_at(g_tile, DA, r, tid - 128);
        part[D + tid - 128] = sv;
      }
      if (tid == kConsumers - 1) {
        float sb = 0.f;
        for (int r = 0; r < kBlockRows; ++r) sb += null_ds[r];
        part[2 * D] = sb;
      }
    }
  }
}

template <int DA>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv,
                   float* __restrict__ dbias, int nq, int nk, int heads) {
  using L = Layout<DA>;
  constexpr int D = 64 * DA;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const Bars bars = init_bars<DA>(base);

  const int k0 = blockIdx.x * kBlockRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int ntiles = (nq + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t rows0 = ((size_t)bi * heads + hh) * nq;
  const size_t keys0 = ((size_t)bi * heads + hh) * nk;

  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<40>();
    if (warp == kConsumers / 32) {
      // per query: lse in the log2 domain (+inf past nq: P = 0) and δ
      produce<DA>(bars, base, &kmap, &vmap, &qmap, &gmap, hh * D, k0, bi,
                  ntiles, [&](int s, int t) {
                    for (int c = lane; c < kCols; c += 32) {
                      const int qr = t * kCols + c;
                      const bool ok = qr < nq;
                      vec[s * 2 * kCols + c] =
                          ok ? to_log2(lse[rows0 + qr]) : INFINITY;
                      vec[s * 2 * kCols + kCols + c] =
                          ok ? delta[rows0 + qr] : 0.f;
                    }
                  });
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = warp / 4;
    const int r_lo = (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int row_blk = 64 * wg + r_lo;
    const uint32_t kw = base + wg * DA * kAtomBytes;
    const uint32_t vw = base + L::kRes + wg * DA * kAtomBytes;

    float b2[2], db[2], adk[DA][32], adv[DA][32];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + row_blk + 8 * i;
      b2[i] = key < nk ? (bias ? to_log2(bias[keys0 + key]) : 0.f)
                       : -INFINITY;  // keys past nk: P = 0
      db[i] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int r = 0; r < 32; ++r) adk[a][r] = adv[a][r] = 0.f;
    mbar_wait(bars.res, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      mbar_wait(bars.full(s), (t / S) & 1);
      const uint32_t qs = base + L::kRing + s * L::kStage;
      const uint32_t gs = qs + L::kTile;

      // rows are keys, columns queries
      float sacc[32], dacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss(sacc, desc_k(kw, kk), desc_k(qs, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss(dacc, desc_k(vw, kk), desc_k(gs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sacc);
      fence_acc(dacc);

      const float* lv = vec + s * 2 * kCols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * j + cq);
        const float2 d2 =
            *reinterpret_cast<const float2*>(lv + kCols + 8 * j + cq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            const float p =
                exp2f(fmaf(sacc[r], kLog2e, b2[i]) - (c ? l2.y : l2.x));
            const float ds = p * (dacc[r] - (c ? d2.y : d2.x));
            db[i] += ds;  // unrounded, as the plain version sums it
            sacc[r] = p;
            dacc[r] = ds;
          }
      }
      uint32_t pf[16], df[16];
      to_frags(sacc, pf);
      to_frags(dacc, df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < DA; ++a) {
          mma_rs_t(adv[a], pf + 4 * kk, desc_mn(gs, a, kk));
          mma_rs_t(adk[a], df + 4 * kk, desc_mn(qs, a, kk));
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int a = 0; a < DA; ++a) {
        fence_acc(adv[a]);
        fence_acc(adk[a]);
      }
      mbar_arrive(bars.empty(s));
    }

    const size_t hd = (size_t)heads * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float colsum = quad_sum(db[i]);
      const int key = k0 + row_blk + 8 * i;
      if (key >= nk) continue;
      const size_t off = ((size_t)bi * nk + key) * hd + hh * D;
#pragma unroll
      for (int a = 0; a < DA; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * a + 8 * j + cq;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(adk[a][4 * j + 2 * i],
                                    adk[a][4 * j + 2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(adv[a][4 * j + 2 * i],
                                    adv[a][4 * j + 2 * i + 1]);
        }
      if (dbias && lane % 4 == 0) dbias[keys0 + key] = colsum;
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DA>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const void* nullk, const void* nullv,
                   const float* null_bias, const void* g, const void* out,
                   const float* lse, void* dq, void* dk, void* dv,
                   float* dbias, float* delta, float* null_part, float* dnk,
                   float* dnv, float* dnb, int b, int nq, int nk, int heads,
                   int have_null, cudaStream_t stream) {
  constexpr int D = 64 * DA;
  const int hd = heads * D;
  CUtensorMap qmap, kmap, vmap, gmap;
  cudaError_t err = make_map(&qmap, q, b, nq, hd);
  if (err == cudaSuccess) err = make_map(&kmap, k, b, nk, hd);
  if (err == cudaSuccess) err = make_map(&vmap, v, b, nk, hd);
  if (err == cudaSuccess) err = make_map(&gmap, g, b, nq, hd);
  auto dq_kernel = bwd_dq_tc_kernel<DA>;
  auto dkdv_kernel = bwd_dkdv_tc_kernel<DA>;
  const int smem = Layout<DA>::kBytes;
  if (err == cudaSuccess) err = set_smem(dq_kernel, smem);
  if (err == cudaSuccess) err = set_smem(dkdv_kernel, smem);
  if (err != cudaSuccess) return err;
  const int qblocks = (nq + kBlockRows - 1) / kBlockRows;
  dq_kernel<<<dim3(qblocks, heads, b), kThreads, smem, stream>>>(
      qmap, kmap, vmap, gmap, bias, static_cast<const __nv_bfloat16*>(nullk),
      static_cast<const __nv_bfloat16*>(nullv), null_bias,
      static_cast<const __nv_bfloat16*>(out), lse,
      static_cast<__nv_bfloat16*>(dq), delta, null_part, nq, nk, heads,
      have_null);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((nk + kBlockRows - 1) / kBlockRows, heads, b), kThreads,
                smem, stream>>>(qmap, kmap, vmap, gmap, bias, lse, delta,
                                static_cast<__nv_bfloat16*>(dk),
                                static_cast<__nv_bfloat16*>(dv), dbias, nq,
                                nk, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess || !have_null) return err;
  flash::null_reduce_kernel<<<heads, flash::kThreads, 0, stream>>>(
      null_part, dnk, dnv, dnb, b * qblocks, heads, D);
  return cudaGetLastError();
}

}  // namespace

// bf16 operands, head dim 64 or 128, every (b, n, H·d) pointer 16-byte
// aligned.  `bias`/`dbias` may be null (dot product); the null-token
// pointers may be null when have_null is 0.  `delta` is a (b, H, nq) fp32
// workspace, `null_part` one of at least b·ceil(nq/128)·H·(2d+1) floats.
// Returns a cudaError_t.
extern "C" int gigagan_flash_attention_fused_bwd_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias,
    const void* g, const void* out, const void* lse, void* dq, void* dk,
    void* dv, void* dbias, void* delta, void* null_part, void* dnullk,
    void* dnullv, void* dnull_bias, int b, int nq, int nk, int heads, int d,
    int have_null, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || (d != 64 && d != 128) ||
      (bias == nullptr) != (dbias == nullptr) ||
      (have_null && (nullk == nullptr || nullv == nullptr ||
                     null_bias == nullptr || null_part == nullptr ||
                     dnullk == nullptr || dnullv == nullptr ||
                     dnull_bias == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  const float* nbf = static_cast<const float*>(null_bias);
  const float* lf = static_cast<const float*>(lse);
  float* dbf = static_cast<float*>(dbias);
  float* delf = static_cast<float*>(delta);
  float* npf = static_cast<float*>(null_part);
  float* dnk = static_cast<float*>(dnullk);
  float* dnv = static_cast<float*>(dnullv);
  float* dnb = static_cast<float*>(dnull_bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<1>(q, k, v, bf, nullk, nullv, nbf, g, out, lf, dq, dk, dv,
                     dbf, delf, npf, dnk, dnv, dnb, b, nq, nk, heads,
                     have_null, s);
  return launch<2>(q, k, v, bf, nullk, nullv, nbf, g, out, lf, dq, dk, dv, dbf,
                   delf, npf, dnk, dnv, dnb, b, nq, nk, heads, have_null, s);
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
