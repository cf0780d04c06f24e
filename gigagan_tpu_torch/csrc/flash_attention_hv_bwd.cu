// Backward of the attention-and-tangent pair (kernel K7b) on CUDA cores:
// the route for fp32 and every head dim but bf16 at 64, which
// flash_attention_hv_bwd_tc.cu takes on the tensor cores.
//
// Replaces the Pallas TPU kernel `_jvp_bwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_hv.py (called through
// `_pair_bwd`): the reverse pass of the forward-over-reverse R1 penalty
// through K7a.  Operands are K7a's (q, k̂, v, bias, tq, t̂k, tv, tbias; bh
// rows of (n, d), bias rows (bh, nk) fp32), its lse, and the cotangents ĝo
// (of out; may be absent) and ĝt (of tout).  Per (b·h), with
// A = exp(S − lse), T the tangent logits, μ = rowsum(A⊙T):
//
//   ĝtA = ĝt vᵀ   r = rowsum(A⊙ĝtA)
//   ĝA = ĝo vᵀ + ĝt tvᵀ + ĝtA⊙(T − μ) − T⊙r   ρ = rowsum(A⊙ĝA)
//   ĝT = A⊙(ĝtA − r)   ĝS = A⊙(ĝA − ρ)
//   ĝq = ĝS k̂ + ĝT t̂k   ĝtq = ĝT k̂
//   ĝk̂ = ĝSᵀ q + ĝTᵀ tq   ĝt̂k = ĝTᵀ q   ĝbias = colsum(ĝS)   ĝtbias = colsum(ĝT)
//   ĝv = Aᵀ ĝo + (A⊙(T − μ))ᵀ ĝt   ĝtv = Aᵀ ĝt
//
// The row statistics need no extra pass of their own: with
// s₃ = rowsum(A⊙(ĝo vᵀ + ĝt tvᵀ + ĝtA⊙T)), ρ = s₃ − 2μr.
//
// What bounds it on an H100: arithmetic (six logit-sized products per
// tile) and registers: the TPU kernel holds A, T, ĝA and ĝT of a q-tile
// at once and carries six key-sized accumulators across its sequential
// q-tile loop.  Blocks on the card run in no order, so this is the
// FlashAttention-2 split into three kernels with no float atomics:
//
// 1. `hv_bwd_q_kernel`, query-major, one block per (64-query tile, b·h):
//    pass 1 over the key tiles gives μ, r and ρ per row (written out for
//    the key-major kernels); pass 2 accumulates ĝq and ĝtq.
// 2. `hv_bwd_k_kernel`, key-major, one block per (64-key tile, b·h):
//    streams the query tiles and accumulates ĝk̂, ĝt̂k and both column sums.
// 3. `hv_bwd_v_kernel`, key-major: ĝv and ĝtv (it needs only A and T).
//
// The streamed tiles (keys in 1., queries in 2. and 3.) hold KC rows:
// KC = 64 for d ≤ 64, and KC = 32 for 64 < d ≤ 128, which halves them and
// the (64, KC) maps so that the shared memory fits.
//
// Splitting the key-major work in two keeps each kernel at two (8 × d/16)
// accumulators per thread beside the (8 × 4) logit tiles.  ĝS, ĝT, A and
// A⊙(T − μ) are rounded to the operand dtype before their products, as the
// TPU kernel casts them for the MXU; ĝk̂ and ĝt̂k are written in fp32, as
// the TPU kernel writes them.  Shared memory: eight staged tiles and two
// maps, 172 KB at d = 64 and 219 KB at d = 128, so one block per SM.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const void* tq;
  const void* tk;
  const void* tv;
  const float* tbias;
  const float* lse;
  const void* go;  // may be null
  const void* gt;
  float* stats;    // (bh, nq, 3): μ, r, ρ
  int nq, nk, d;
};

template <typename T>
__device__ __forceinline__ const T* as(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
hv_bwd_q_kernel(Operands o, T* __restrict__ gq, T* __restrict__ gtq) {
  constexpr int KC = kLanes * CPT;  // keys per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nq = o.nq, nk = o.nk, d = o.d;
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* qs = smem;                  // (64, ds) query-side tiles
  float* tqs = qs + kTile * ds;
  float* gos = tqs + kTile * ds;
  float* gts = gos + kTile * ds;
  float* ks = gts + kTile * ds;      // (KC, ds) key-side tiles
  float* tks = ks + KC * ds;
  float* vs = tks + KC * ds;
  float* tvs = vs + KC * ds;
  float* pgs = tvs + KC * ds;        // (64, KC) ĝS
  float* pgt = pgs + kTile * KC;     // (64, KC) ĝT

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d + (size_t)q0 * d;
  const size_t koff = bh * nk * d;
  const float* bias_b = o.bias + bh * nk;
  const float* tbias_b = o.tbias + bh * nk;
  const size_t row0 = bh * nq + q0;
  const bool have_go = o.go != nullptr;

  load_tile(qs, as<T>(o.q) + qoff, nq - q0, d, d, ds);
  load_tile(tqs, as<T>(o.tq) + qoff, nq - q0, d, d, ds);
  load_tile(gts, as<T>(o.gt) + qoff, nq - q0, d, d, ds);
  if (have_go) load_tile(gos, as<T>(o.go) + qoff, nq - q0, d, d, ds);

  float lse_r[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    lse_r[i] = q0 + row < nq ? o.lse[row0 + row] : INFINITY;  // A = 0
  }

  auto stage_keys = [&](int k0) {
    __syncthreads();  // previous key tile consumed
    const size_t kt = koff + (size_t)k0 * d;
    load_tile(ks, as<T>(o.k) + kt, nk - k0, d, d, ds, KC);
    load_tile(tks, as<T>(o.tk) + kt, nk - k0, d, d, ds, KC);
    load_tile(vs, as<T>(o.v) + kt, nk - k0, d, d, ds, KC);
    load_tile(tvs, as<T>(o.tv) + kt, nk - k0, d, d, ds, KC);
    __syncthreads();
  };
  // A and T of a key tile (0 past nk), and ĝtA = ĝt vᵀ
  auto a_t_gta = [&](int k0, float (&a)[kRpt][CPT], float (&t)[kRpt][CPT],
                     float (&gta)[kRpt][CPT]) {
    zero(a);
    zero(t);
    zero(gta);
    tile_dot(a, qs, ks, ds, d4);
    tile_dot(t, tqs, ks, ds, d4);
    tile_dot(t, qs, tks, ds, d4);
    tile_dot(gta, gts, vs, ds, d4);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int key = k0 + tx + kLanes * j;
      const bool ok = key < nk;
      const float b = ok ? bias_b[key] : 0.f;
      const float tb = ok ? tbias_b[key] : 0.f;
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        a[i][j] = ok ? expf(a[i][j] + b - lse_r[i]) : 0.f;
        t[i][j] = ok ? t[i][j] + tb : 0.f;
      }
    }
  };
  // ĝo vᵀ + ĝt tvᵀ
  auto g1 = [&](float (&acc)[kRpt][CPT]) {
    zero(acc);
    if (have_go) tile_dot(acc, gos, vs, ds, d4);
    tile_dot(acc, gts, tvs, ds, d4);
  };

  // pass 1: μ, r and s₃ = rowsum(A⊙(ĝo vᵀ + ĝt tvᵀ + ĝtA⊙T))
  float mu[kRpt], r[kRpt], rho[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) mu[i] = r[i] = rho[i] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += KC) {
    stage_keys(k0);
    float a[kRpt][CPT], t[kRpt][CPT], gta[kRpt][CPT];
    a_t_gta(k0, a, t, gta);
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        mu[i] += a[i][j] * t[i][j];
        r[i] += a[i][j] * gta[i][j];
        rho[i] += a[i][j] * gta[i][j] * t[i][j];
      }
    float g[kRpt][CPT];
    g1(g);
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) rho[i] += a[i][j] * g[i][j];
  }
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    mu[i] = half_warp_sum(mu[i]);
    r[i] = half_warp_sum(r[i]);
    rho[i] = half_warp_sum(rho[i]) - 2.f * mu[i] * r[i];
    const int row = ty * kRpt + i;
    if (q0 + row < nq && tx == 0) {
      float* st = o.stats + (row0 + row) * 3;
      st[0] = mu[i];
      st[1] = r[i];
      st[2] = rho[i];
    }
  }

  // pass 2: ĝq = ĝS k̂ + ĝT t̂k and ĝtq = ĝT k̂
  float acc_q[kRpt][DC], acc_tq[kRpt][DC];
  zero(acc_q);
  zero(acc_tq);
  for (int k0 = 0; k0 < nk; k0 += KC) {
    stage_keys(k0);
    float a[kRpt][CPT], t[kRpt][CPT], gta[kRpt][CPT];
    a_t_gta(k0, a, t, gta);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float* trow = pgt + (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        trow[tx + kLanes * j] = round_to<T>(a[i][j] * (gta[i][j] - r[i]));
        // the ĝA terms without ĝo vᵀ + ĝt tvᵀ
        gta[i][j] = gta[i][j] * (t[i][j] - mu[i]) - t[i][j] * r[i];
      }
    }
    float g[kRpt][CPT];
    g1(g);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float* srow = pgs + (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        srow[tx + kLanes * j] =
            round_to<T>(a[i][j] * (g[i][j] + gta[i][j] - rho[i]));
      }
    }
    __syncwarp();
    tile_mm<DC, CPT>(acc_q, pgs, ks, ds, d);
    tile_mm<DC, CPT>(acc_q, pgt, tks, ds, d);
    tile_mm<DC, CPT>(acc_tq, pgt, ks, ds, d);
    __syncwarp();  // the maps are consumed before the next overwrite
  }
  store_rows<T, DC>(gq + qoff, acc_q, nq - q0, d);
  store_rows<T, DC>(gtq + qoff, acc_tq, nq - q0, d);
}

// The staged query tile q0 (kc queries) of a key-major kernel: its rows'
// lse and statistics (columns past nq get lse = inf, so A = 0 there)
__device__ __forceinline__ void stage_rows(const Operands& o, size_t row0,
                                           int q0, int kc, float* lse_s,
                                           float* mu_s, float* r_s,
                                           float* rho_s) {
  for (int c = threadIdx.x; c < kc; c += kThreads) {
    const bool valid = q0 + c < o.nq;
    const float* st = o.stats + (row0 + q0 + c) * 3;
    lse_s[c] = valid ? o.lse[row0 + q0 + c] : INFINITY;
    mu_s[c] = valid ? st[0] : 0.f;
    r_s[c] = valid ? st[1] : 0.f;
    if (rho_s) rho_s[c] = valid ? st[2] : 0.f;
  }
}

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
hv_bwd_k_kernel(Operands o, float* __restrict__ gk, float* __restrict__ gtk,
                float* __restrict__ gbias, float* __restrict__ gtbias) {
  constexpr int KC = kLanes * CPT;  // queries per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nq = o.nq, nk = o.nk, d = o.d;
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* ks = smem;                  // (64, ds) this block's keys
  float* tks = ks + kTile * ds;
  float* vs = tks + kTile * ds;
  float* tvs = vs + kTile * ds;
  float* qs = tvs + kTile * ds;      // (KC, ds) current query tile
  float* tqs = qs + KC * ds;
  float* gos = tqs + KC * ds;
  float* gts = gos + KC * ds;
  float* pgs = gts + KC * ds;        // (64 keys, KC queries) ĝS
  float* pgt = pgs + kTile * KC;     // ĝT
  float* lse_s = pgt + kTile * KC;
  float* mu_s = lse_s + KC;
  float* r_s = mu_s + KC;
  float* rho_s = r_s + KC;

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d;
  const size_t koff = bh * nk * d + (size_t)k0 * d;
  const size_t row0 = bh * nq;
  const bool have_go = o.go != nullptr;

  load_tile(ks, as<T>(o.k) + koff, nk - k0, d, d, ds);
  load_tile(tks, as<T>(o.tk) + koff, nk - k0, d, d, ds);
  load_tile(vs, as<T>(o.v) + koff, nk - k0, d, d, ds);
  load_tile(tvs, as<T>(o.tv) + koff, nk - k0, d, d, ds);

  float bk[kRpt], tbk[kRpt], cs[kRpt], cts[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const bool ok = key < nk;
    // keys past nk: A = exp(-inf) = 0
    bk[i] = ok ? o.bias[bh * nk + key] : -INFINITY;
    tbk[i] = ok ? o.tbias[bh * nk + key] : 0.f;
    cs[i] = cts[i] = 0.f;
  }
  float acc_k[kRpt][DC], acc_tk[kRpt][DC];
  zero(acc_k);
  zero(acc_tk);

  for (int q0 = 0; q0 < nq; q0 += KC) {
    __syncthreads();  // previous query tile consumed
    const size_t qt = qoff + (size_t)q0 * d;
    load_tile(qs, as<T>(o.q) + qt, nq - q0, d, d, ds, KC);
    load_tile(tqs, as<T>(o.tq) + qt, nq - q0, d, d, ds, KC);
    load_tile(gts, as<T>(o.gt) + qt, nq - q0, d, d, ds, KC);
    if (have_go) load_tile(gos, as<T>(o.go) + qt, nq - q0, d, d, ds, KC);
    stage_rows(o, row0, q0, KC, lse_s, mu_s, r_s, rho_s);
    __syncthreads();

    // rows are keys i, columns queries j
    float a[kRpt][CPT], t[kRpt][CPT], gta[kRpt][CPT];
    zero(a);
    zero(t);
    zero(gta);
    tile_dot(a, ks, qs, ds, d4);
    tile_dot(t, ks, tqs, ds, d4);
    tile_dot(t, tks, qs, ds, d4);
    tile_dot(gta, vs, gts, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float* trow = pgt + (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        a[i][j] = expf(a[i][j] + bk[i] - lse_s[col]);
        t[i][j] += tbk[i];
        const float g_t = a[i][j] * (gta[i][j] - r_s[col]);
        cts[i] += g_t;
        trow[col] = round_to<T>(g_t);
        gta[i][j] = gta[i][j] * (t[i][j] - mu_s[col]) - t[i][j] * r_s[col];
      }
    }
    float g[kRpt][CPT];
    zero(g);
    if (have_go) tile_dot(g, vs, gos, ds, d4);
    tile_dot(g, tvs, gts, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float* srow = pgs + (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        const float g_s = a[i][j] * (g[i][j] + gta[i][j] - rho_s[col]);
        cs[i] += g_s;
        srow[col] = round_to<T>(g_s);
      }
    }
    __syncwarp();
    tile_mm<DC, CPT>(acc_k, pgs, qs, ds, d);
    tile_mm<DC, CPT>(acc_k, pgt, tqs, ds, d);
    tile_mm<DC, CPT>(acc_tk, pgt, qs, ds, d);
    __syncwarp();
  }

  store_rows<float, DC>(gk + koff, acc_k, nk - k0, d);
  store_rows<float, DC>(gtk + koff, acc_tk, nk - k0, d);
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const float c_s = half_warp_sum(cs[i]);
    const float c_t = half_warp_sum(cts[i]);
    if (key < nk && tx == 0) {
      gbias[bh * nk + key] = c_s;
      gtbias[bh * nk + key] = c_t;
    }
  }
}

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
hv_bwd_v_kernel(Operands o, T* __restrict__ gv, T* __restrict__ gtv) {
  constexpr int KC = kLanes * CPT;  // queries per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nq = o.nq, nk = o.nk, d = o.d;
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* ks = smem;                  // (64, ds) this block's keys
  float* tks = ks + kTile * ds;
  float* qs = tks + kTile * ds;      // (KC, ds) current query tile
  float* tqs = qs + KC * ds;
  float* gos = tqs + KC * ds;
  float* gts = gos + KC * ds;
  float* pa = gts + KC * ds;         // (64 keys, KC queries) A
  float* pta = pa + kTile * KC;      // A⊙(T − μ)
  float* lse_s = pta + kTile * KC;
  float* mu_s = lse_s + KC;
  float* r_s = mu_s + KC;

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d;
  const size_t koff = bh * nk * d + (size_t)k0 * d;
  const size_t row0 = bh * nq;
  const bool have_go = o.go != nullptr;

  load_tile(ks, as<T>(o.k) + koff, nk - k0, d, d, ds);
  load_tile(tks, as<T>(o.tk) + koff, nk - k0, d, d, ds);

  float bk[kRpt], tbk[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const bool ok = key < nk;
    bk[i] = ok ? o.bias[bh * nk + key] : -INFINITY;
    tbk[i] = ok ? o.tbias[bh * nk + key] : 0.f;
  }
  float acc_v[kRpt][DC], acc_tv[kRpt][DC];
  zero(acc_v);
  zero(acc_tv);

  for (int q0 = 0; q0 < nq; q0 += KC) {
    __syncthreads();  // previous query tile consumed
    const size_t qt = qoff + (size_t)q0 * d;
    load_tile(qs, as<T>(o.q) + qt, nq - q0, d, d, ds, KC);
    load_tile(tqs, as<T>(o.tq) + qt, nq - q0, d, d, ds, KC);
    load_tile(gts, as<T>(o.gt) + qt, nq - q0, d, d, ds, KC);
    if (have_go) load_tile(gos, as<T>(o.go) + qt, nq - q0, d, d, ds, KC);
    stage_rows(o, row0, q0, KC, lse_s, mu_s, r_s, nullptr);
    __syncthreads();

    float a[kRpt][CPT], t[kRpt][CPT];
    zero(a);
    zero(t);
    tile_dot(a, ks, qs, ds, d4);
    tile_dot(t, ks, tqs, ds, d4);
    tile_dot(t, tks, qs, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int r = (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        const float av = expf(a[i][j] + bk[i] - lse_s[col]);
        pa[r + col] = round_to<T>(av);
        pta[r + col] = round_to<T>(av * (t[i][j] + tbk[i] - mu_s[col]));
      }
    }
    __syncwarp();
    if (have_go) tile_mm<DC, CPT>(acc_v, pa, gos, ds, d);
    tile_mm<DC, CPT>(acc_v, pta, gts, ds, d);
    tile_mm<DC, CPT>(acc_tv, pa, gts, ds, d);
    __syncwarp();
  }
  store_rows<T, DC>(gv + koff, acc_v, nk - k0, d);
  store_rows<T, DC>(gtv + koff, acc_tv, nk - k0, d);
}

// kc: rows of the streamed tiles
inline size_t q_smem(int d, int kc) {
  return sizeof(float) *
         (size_t)((4 * kTile + 4 * kc) * tile_stride(d) + 2 * kTile * kc);
}

inline size_t k_smem(int d, int kc) {
  return q_smem(d, kc) + sizeof(float) * 4 * kc;
}

inline size_t v_smem(int d, int kc) {
  return sizeof(float) * (size_t)((2 * kTile + 4 * kc) * tile_stride(d) +
                                  2 * kTile * kc + 3 * kc);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DC, int CPT>
cudaError_t launch(const Operands& o, int bh, void* gq, float* gk, void* gv,
                   float* gbias, void* gtq, float* gtk, void* gtv,
                   float* gtbias, cudaStream_t stream) {
  auto qk = hv_bwd_q_kernel<T, DC, CPT>;
  auto kk = hv_bwd_k_kernel<T, DC, CPT>;
  auto vk = hv_bwd_v_kernel<T, DC, CPT>;
  const int d = o.d;
  const int kc = kLanes * CPT;
  const size_t qb = q_smem(d, kc), kb = k_smem(d, kc), vb = v_smem(d, kc);
  cudaError_t err = set_smem(qk, qb);
  if (err == cudaSuccess) err = set_smem(kk, kb);
  if (err == cudaSuccess) err = set_smem(vk, vb);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((o.nq + kTile - 1) / kTile, bh);
  const dim3 kgrid((o.nk + kTile - 1) / kTile, bh);
  qk<<<qgrid, kThreads, qb, stream>>>(o, static_cast<T*>(gq),
                                      static_cast<T*>(gtq));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kk<<<kgrid, kThreads, kb, stream>>>(o, gk, gtk, gbias, gtbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vk<<<kgrid, kThreads, vb, stream>>>(o, static_cast<T*>(gv),
                                      static_cast<T*>(gtv));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Operands& o, int bh, void* gq, float* gk,
                     void* gv, float* gbias, void* gtq, float* gtk, void* gtv,
                     float* gtbias, cudaStream_t s) {
#define GIGAGAN_K7B_LAUNCH(DC, CPT)                                         \
  return launch<T, DC, CPT>(o, bh, gq, gk, gv, gbias, gtq, gtk, gtv, gtbias, \
                            s)
  if (o.d <= 16) GIGAGAN_K7B_LAUNCH(1, 4);
  if (o.d <= 32) GIGAGAN_K7B_LAUNCH(2, 4);
  if (o.d <= 64) GIGAGAN_K7B_LAUNCH(4, 4);
  GIGAGAN_K7B_LAUNCH(8, 2);
#undef GIGAGAN_K7B_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `go` may be null (no cotangent
// on out).  gk, gtk, gbias and gtbias are fp32; `stats` is a (bh, nq, 3)
// fp32 workspace.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_hv_bwd_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* tq, const void* tk, const void* tv, const void* tbias,
    const void* lse, const void* go, const void* gt, void* gq, void* gk,
    void* gv, void* gbias, void* gtq, void* gtk, void* gtv, void* gtbias,
    void* stats, int bh, int nq, int nk, int d, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > 128) {
    return cudaErrorInvalidValue;
  }
  Operands o{q,  k,  v, static_cast<const float*>(bias), tq, tk, tv,
             static_cast<const float*>(tbias), static_cast<const float*>(lse),
             go, gt, static_cast<float*>(stats), nq, nk, d};
  float* gkf = static_cast<float*>(gk);
  float* gtkf = static_cast<float*>(gtk);
  float* gbf = static_cast<float*>(gbias);
  float* gtbf = static_cast<float*>(gtbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(o, bh, gq, gkf, gv, gbf, gtq, gtkf, gtv, gtbf, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(o, bh, gq, gkf, gv, gbf, gtq, gtkf, gtv,
                                   gtbf, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
