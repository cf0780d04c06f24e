// Adjoint of the fused-heads attention backward (kernel K5): the second
// derivative of softmax attention that the R1 gradient penalty's double
// backward needs.
//
// Replaces the Pallas TPU kernel `_bwd2_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_so.py (called through
// `_bwd_so_bwd`).  It is the adjoint of K4 on K3's PREPARED operands
// (q, k_pre, v, bias, nullk_pre, nullv, null_bias) and K4's cotangent
// input g, given cotangents Ã, B̃, C̃, D̃, Ẽ, F̃, H̃ of K4's outputs (dq,
// dk_pre, dv, dbias, dnullk_pre, dnullv, dnull_bias).  K3's lse is a
// constant to K4, so this kernel carries the softmax normalizer's
// dependence itself; per head, with the null column n in every row sum:
//
//   P = exp(q·k_preᵀ + bias − lse)   dA = g·vᵀ   δ = Σ P dA
//   c_dS = Ã·k_preᵀ + q·B̃ᵀ + D̃       c_dSⁿ = Ã·nullk_pre + q·Ẽ + H̃
//   r₁ = Σ P c_dS dA   r₂ = Σ P c_dS   r₃ = Σ P (g·C̃ᵀ)   ρ = r₁ + r₃ − 2δ r₂
//   dS = P (dA − δ)    c_dA = P (c_dS − r₂)
//   c_S = P (c_dS (dA − δ) + g·C̃ᵀ − r₂ dA − ρ)
//   c_q = c_S·k_pre + dS·B̃ + c_Sⁿ nullk_pre + dSⁿ Ẽ
//   c_g = c_dA·v + P·C̃ + c_dAⁿ nullv + Pⁿ F̃
//   c_k_pre = c_Sᵀ·q + dSᵀ·Ã   c_v = c_dAᵀ·g   c_bias = colsum(c_S)
//   c_nullk_pre = Σ (c_Sⁿ q + dSⁿ Ã)   c_nullv = Σ c_dAⁿ g   c_null_bias = Σ c_Sⁿ
//
// What bounds it on an H100: five (n, n) products over d to rebuild the
// pieces and four back, per (sample, head), at the discriminator's R1 shapes
// (b = 64, n = 1024 and b = 128, n = 256, d = 64): arithmetic-bound, and
// the (n, n) pieces must stay on chip.  Design, as K4's:
//
// 1. `so_bwd2_q_kernel`, query-major, one block per (64-query tile, head,
//    sample): a first pass over the key tiles forms the row statistics
//    (δ, r₂, ρ) and writes them for step 2; a second pass rebuilds the
//    pieces and accumulates c_q and c_g in registers.  It writes per-block
//    partials of the null cotangents.
// 2. `so_bwd2_k_kernel`, key-major, one block per (64-key tile, head,
//    sample): streams the query tiles with their statistics and accumulates
//    c_k_pre, c_v and the c_bias column sum.
// 3. `null_reduce_kernel`: the null partials added in a fixed order.
//
// The (64, KC) pieces pass through shared memory, rounded to the operand
// dtype, for the products.  No float atomics: the result is deterministic.
// Simple first version: CUDA-core FMAs, no tensor cores, no TMA; the
// query-major kernel needs ~185 KB of shared memory at d = 64, so one block
// runs per SM.  For d > 64 the streamed tiles (keys in the query-major
// kernel, queries in the key-major one) hold KC = 32 rows instead of 64, so
// that the shared memory fits (202 and 211 KB at d = 128), as K7b does.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
so_bwd2_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ nullk, const T* __restrict__ nullv,
                 const float* __restrict__ null_bias, const T* __restrict__ g,
                 const float* __restrict__ lse, const T* __restrict__ ca,
                 const T* __restrict__ cb, const T* __restrict__ cc,
                 const float* __restrict__ cdbias,
                 const float* __restrict__ ce, const float* __restrict__ cf,
                 const float* __restrict__ ch, T* __restrict__ cq,
                 T* __restrict__ cg, float* __restrict__ stats,
                 float* __restrict__ null_part, int nq, int nk, int heads,
                 int d, int have_null) {
  constexpr int KC = kLanes * CPT;  // keys per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  const int tsz = kTile * ds;
  const int ksz = KC * ds;
  float* qs = smem;          // q-side tiles (64 rows): q, g, Ã
  float* gs = qs + tsz;
  float* as = gs + tsz;
  float* ks = as + tsz;      // key-side tiles (KC rows): k_pre, v, B̃, C̃
  float* vs = ks + ksz;
  float* bs = vs + ksz;
  float* cs = bs + ksz;
  float* t1 = cs + ksz;      // (64, KC) pieces: c_S, dS, c_dA, P
  float* t2 = t1 + kTile * KC;
  float* t3 = t2 + kTile * KC;
  float* t4 = t3 + kTile * KC;
  float* kb_s = t4 + kTile * KC;  // (KC) bias of the key tile
  float* kd_s = kb_s + KC;        // (KC) D̃ of the key tile

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * kTile;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t hd = (size_t)heads * d;
  const size_t qoff = (size_t)bi * nq * hd + (size_t)hh * d;
  const size_t koff = (size_t)bi * nk * hd + (size_t)hh * d;
  const size_t row0 = ((size_t)bi * heads + hh) * nq;
  const size_t key0 = ((size_t)bi * heads + hh) * nk;

  load_tile(qs, q + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
  load_tile(gs, g + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
  load_tile(as, ca + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
  __syncthreads();

  // the null column, per row
  float lse_r[kRpt], pn[kRpt], dan[kRpt], cdsn[kRpt], gfn[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    const bool valid = q0 + row < nq;
    lse_r[i] = valid ? lse[row0 + q0 + row] : INFINITY;
    pn[i] = dan[i] = cdsn[i] = gfn[i] = 0.f;
    if (have_null) {
      const T* nk_h = nullk + (size_t)hh * d;
      const T* nv_h = nullv + (size_t)hh * d;
      const float* e_h = ce + (size_t)hh * d;
      const float* f_h = cf + (size_t)hh * d;
      float sn = 0.f, an = 0.f, cn = 0.f, fn = 0.f;
      for (int dd = tx; dd < d; dd += kLanes) {
        const float nkv = to_f32(nk_h[dd]);
        sn += qs[row * ds + dd] * nkv;
        an += gs[row * ds + dd] * to_f32(nv_h[dd]);
        cn += as[row * ds + dd] * nkv + qs[row * ds + dd] * e_h[dd];
        fn += gs[row * ds + dd] * f_h[dd];
      }
      sn = half_warp_sum(sn) + null_bias[hh];
      pn[i] = valid ? expf(sn - lse_r[i]) : 0.f;
      dan[i] = half_warp_sum(an);
      cdsn[i] = half_warp_sum(cn) + ch[hh];
      gfn[i] = half_warp_sum(fn);
    }
  }

  // ---- pass 1: row statistics
  float r1[kRpt], r2[kRpt], r3[kRpt], r4[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) r1[i] = r2[i] = r3[i] = r4[i] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += KC) {
    __syncthreads();
    load_tile(ks, k + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(vs, v + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(bs, cb + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(cs, cc + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    for (int r = threadIdx.x; r < KC; r += kThreads) {
      const bool ok = k0 + r < nk;
      kb_s[r] = (ok && bias) ? bias[key0 + k0 + r] : 0.f;
      kd_s[r] = (ok && cdbias) ? cdbias[key0 + k0 + r] : 0.f;
    }
    __syncthreads();

    float p[kRpt][CPT], x[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) p[i][j] = x[i][j] = 0.f;
    tile_dot(p, qs, ks, ds, d4);
    tile_dot(x, gs, vs, ds, d4);  // dA
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        p[i][j] = k0 + col < nk ? expf(p[i][j] + kb_s[col] - lse_r[i]) : 0.f;
        r4[i] += p[i][j] * x[i][j];
      }
    float y[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) y[i][j] = 0.f;
    tile_dot(y, as, ks, ds, d4);
    tile_dot(y, qs, bs, ds, d4);  // c_dS without D̃
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pc = p[i][j] * (y[i][j] + kd_s[tx + kLanes * j]);
        r1[i] += pc * x[i][j];
        r2[i] += pc;
        y[i][j] = 0.f;
      }
    tile_dot(y, gs, cs, ds, d4);  // g·C̃ᵀ
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) r3[i] += p[i][j] * y[i][j];
  }
  float del[kRpt], rho[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    del[i] = half_warp_sum(r4[i]) + pn[i] * dan[i];
    const float s1 = half_warp_sum(r1[i]) + pn[i] * cdsn[i] * dan[i];
    r2[i] = half_warp_sum(r2[i]) + pn[i] * cdsn[i];
    const float s3 = half_warp_sum(r3[i]) + pn[i] * gfn[i];
    rho[i] = s1 + s3 - 2.f * del[i] * r2[i];
    if (q0 + row < nq && tx == 0) {
      float* st = stats + (row0 + q0 + row) * 3;
      st[0] = del[i];
      st[1] = r2[i];
      st[2] = rho[i];
    }
  }

  // ---- pass 2: c_q and c_g
  float acq[kRpt][DC], acg[kRpt][DC];
  float pk[DC], pv[DC], pb = 0.f;
#pragma unroll
  for (int c = 0; c < DC; ++c) pk[c] = pv[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acq[i][c] = acg[i][c] = 0.f;
    if (have_null) {
      const int row = ty * kRpt + i;
      const float dsn = pn[i] * (dan[i] - del[i]);
      const float c_dan = pn[i] * (cdsn[i] - r2[i]);
      const float c_sn = pn[i] * (cdsn[i] * (dan[i] - del[i]) + gfn[i] -
                                  r2[i] * dan[i] - rho[i]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dd = tx + kLanes * c;
        if (dd < d) {
          acq[i][c] = c_sn * to_f32(nullk[(size_t)hh * d + dd]) +
                      dsn * ce[(size_t)hh * d + dd];
          acg[i][c] = c_dan * to_f32(nullv[(size_t)hh * d + dd]) +
                      pn[i] * cf[(size_t)hh * d + dd];
          pk[c] += c_sn * qs[row * ds + dd] + dsn * as[row * ds + dd];
          pv[c] += c_dan * gs[row * ds + dd];
        }
      }
      pb += c_sn;
    }
  }
  for (int k0 = 0; k0 < nk; k0 += KC) {
    __syncthreads();
    load_tile(ks, k + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(vs, v + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(bs, cb + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    load_tile(cs, cc + koff + (size_t)k0 * hd, nk - k0, hd, d, ds, KC);
    for (int r = threadIdx.x; r < KC; r += kThreads) {
      const bool ok = k0 + r < nk;
      kb_s[r] = (ok && bias) ? bias[key0 + k0 + r] : 0.f;
      kd_s[r] = (ok && cdbias) ? cdbias[key0 + k0 + r] : 0.f;
    }
    __syncthreads();

    float p[kRpt][CPT], x[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) p[i][j] = x[i][j] = 0.f;
    tile_dot(p, qs, ks, ds, d4);
    tile_dot(x, gs, vs, ds, d4);  // dA
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        p[i][j] = k0 + col < nk ? expf(p[i][j] + kb_s[col] - lse_r[i]) : 0.f;
        t2[row * KC + col] = round_to<T>(p[i][j] * (x[i][j] - del[i]));
        t4[row * KC + col] = round_to<T>(p[i][j]);
      }
    }
    float y[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) y[i][j] = 0.f;
    tile_dot(y, as, ks, ds, d4);
    tile_dot(y, qs, bs, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        const float cds = y[i][j] + kd_s[col];
        t3[row * KC + col] = round_to<T>(p[i][j] * (cds - r2[i]));
        // x becomes c_dS (dA − δ) − r₂ dA − ρ
        x[i][j] = cds * (x[i][j] - del[i]) - r2[i] * x[i][j] - rho[i];
        y[i][j] = 0.f;
      }
    }
    tile_dot(y, gs, cs, ds, d4);  // g·C̃ᵀ
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        t1[row * KC + tx + kLanes * j] =
            round_to<T>(p[i][j] * (x[i][j] + y[i][j]));
      }
    }
    __syncwarp();
    tile_mm<DC, CPT>(acq, t1, ks, ds, d);
    tile_mm<DC, CPT>(acq, t2, bs, ds, d);
    tile_mm<DC, CPT>(acg, t3, vs, ds, d);
    tile_mm<DC, CPT>(acg, t4, cs, ds, d);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int grow = q0 + ty * kRpt + i;
    if (grow >= nq) continue;
    T* qrow = cq + qoff + (size_t)grow * hd;
    T* grow_out = cg + qoff + (size_t)grow * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) {
        qrow[dd] = from_f32<T>(acq[i][c]);
        grow_out[dd] = from_f32<T>(acg[i][c]);
      }
    }
  }
  if (have_null) {
    const int slot = bi * gridDim.x + blockIdx.x;
    write_null_partial<DC>(pk, pv, pb, t1, null_part +
                           ((size_t)slot * heads + hh) * (2 * d + 1), d);
  }
}

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
so_bwd2_k_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ g, const float* __restrict__ lse,
                 const T* __restrict__ ca, const T* __restrict__ cb,
                 const T* __restrict__ cc, const float* __restrict__ cdbias,
                 const float* __restrict__ stats, T* __restrict__ ck,
                 T* __restrict__ cv, float* __restrict__ cbias, int nq, int nk,
                 int heads, int d) {
  constexpr int KC = kLanes * CPT;  // queries per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  const int tsz = kTile * ds;
  const int qsz = KC * ds;
  float* ks = smem;          // this block's keys (64 rows): k_pre, v, B̃, C̃
  float* vs = ks + tsz;
  float* bs = vs + tsz;
  float* cs = bs + tsz;
  float* qs = cs + tsz;      // the query tile (KC rows): q, g, Ã
  float* gs = qs + qsz;
  float* as = gs + qsz;
  float* t1 = as + qsz;      // (64 keys, KC queries): c_S, dS, c_dA
  float* t2 = t1 + kTile * KC;
  float* t3 = t2 + kTile * KC;
  float* lse_s = t3 + kTile * KC;  // per query row: lse, δ, r₂, ρ
  float* del_s = lse_s + KC;
  float* r2_s = del_s + KC;
  float* rho_s = r2_s + KC;

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int k0 = blockIdx.x * kTile;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t hd = (size_t)heads * d;
  const size_t qoff = (size_t)bi * nq * hd + (size_t)hh * d;
  const size_t koff = (size_t)bi * nk * hd + (size_t)hh * d;
  const size_t row0 = ((size_t)bi * heads + hh) * nq;
  const size_t key0 = ((size_t)bi * heads + hh) * nk;

  load_tile(ks, k + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
  load_tile(vs, v + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
  load_tile(bs, cb + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
  load_tile(cs, cc + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);

  float kb[kRpt], kd[kRpt], acb[kRpt], ack[kRpt][DC], acv[kRpt][DC];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    kb[i] = (bias && key < nk) ? bias[key0 + key] : 0.f;
    kd[i] = (cdbias && key < nk) ? cdbias[key0 + key] : 0.f;
    acb[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) ack[i][c] = acv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += KC) {
    __syncthreads();
    load_tile(qs, q + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds, KC);
    load_tile(gs, g + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds, KC);
    load_tile(as, ca + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds, KC);
    for (int r = threadIdx.x; r < KC; r += kThreads) {
      const bool valid = q0 + r < nq;
      const float* st = stats + (row0 + q0 + r) * 3;
      lse_s[r] = valid ? lse[row0 + q0 + r] : INFINITY;
      del_s[r] = valid ? st[0] : 0.f;
      r2_s[r] = valid ? st[1] : 0.f;
      rho_s[r] = valid ? st[2] : 0.f;
    }
    __syncthreads();

    float p[kRpt][CPT], x[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) p[i][j] = x[i][j] = 0.f;
    tile_dot(p, ks, qs, ds, d4);
    tile_dot(x, vs, gs, ds, d4);  // dA (keys × queries)
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
      const bool key_ok = k0 + row < nk;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        p[i][j] = key_ok ? expf(p[i][j] + kb[i] - lse_s[col]) : 0.f;
        t2[row * KC + col] = round_to<T>(p[i][j] * (x[i][j] - del_s[col]));
      }
    }
    float y[kRpt][CPT];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) y[i][j] = 0.f;
    tile_dot(y, ks, as, ds, d4);
    tile_dot(y, bs, qs, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + kLanes * j;
        const float cds = y[i][j] + kd[i];
        t3[row * KC + col] = round_to<T>(p[i][j] * (cds - r2_s[col]));
        x[i][j] = cds * (x[i][j] - del_s[col]) - r2_s[col] * x[i][j] -
                  rho_s[col];
        y[i][j] = 0.f;
      }
    }
    tile_dot(y, cs, gs, ds, d4);  // g·C̃ᵀ
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float c_s = p[i][j] * (x[i][j] + y[i][j]);
        acb[i] += c_s;
        t1[row * KC + tx + kLanes * j] = round_to<T>(c_s);
      }
    }
    __syncwarp();
    tile_mm<DC, CPT>(ack, t1, qs, ds, d);
    tile_mm<DC, CPT>(ack, t2, as, ds, d);
    tile_mm<DC, CPT>(acv, t3, gs, ds, d);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const float colsum = half_warp_sum(acb[i]);
    if (key >= nk) continue;
    T* krow = ck + koff + (size_t)key * hd;
    T* vrow = cv + koff + (size_t)key * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) {
        krow[dd] = from_f32<T>(ack[i][c]);
        vrow[dd] = from_f32<T>(acv[i][c]);
      }
    }
    if (cbias && tx == 0) cbias[key0 + key] = colsum;
  }
}

// kc: rows of the streamed tiles
inline size_t q_smem(int d, int kc) {
  return sizeof(float) * (size_t)((3 * kTile + 4 * kc) * tile_stride(d) +
                                  4 * kTile * kc + 2 * kc);
}

inline size_t k_smem(int d, int kc) {
  return sizeof(float) * (size_t)((4 * kTile + 3 * kc) * tile_stride(d) +
                                  3 * kTile * kc + 4 * kc);
}

struct Args {
  const void *q, *k, *v;
  const float* bias;
  const void *nullk, *nullv;
  const float* null_bias;
  const void* g;
  const float* lse;
  const void *ca, *cb, *cc;
  const float *cdbias, *ce, *cf, *ch;
  void *cq, *ck, *cv, *cg;
  float *cbias, *stats, *null_part, *cnk, *cnv, *cnb;
  int b, nq, nk, heads, d, have_null;
};

template <typename T, int DC, int CPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto qk = so_bwd2_q_kernel<T, DC, CPT>;
  auto kk = so_bwd2_k_kernel<T, DC, CPT>;
  const int kc = kLanes * CPT;
  const size_t qb = q_smem(a.d, kc), kb = k_smem(a.d, kc);
  cudaError_t err = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qb);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kb);
  if (err != cudaSuccess) return err;
  const int qtiles = (a.nq + kTile - 1) / kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const T* ca = static_cast<const T*>(a.ca);
  const T* cb = static_cast<const T*>(a.cb);
  const T* cc = static_cast<const T*>(a.cc);
  qk<<<dim3(qtiles, a.heads, a.b), kThreads, qb, stream>>>(
      q, k, v, a.bias, static_cast<const T*>(a.nullk),
      static_cast<const T*>(a.nullv), a.null_bias, g, a.lse, ca, cb, cc,
      a.cdbias, a.ce, a.cf, a.ch, static_cast<T*>(a.cq), static_cast<T*>(a.cg),
      a.stats, a.null_part, a.nq, a.nk, a.heads, a.d, a.have_null);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kk<<<dim3((a.nk + kTile - 1) / kTile, a.heads, a.b), kThreads, kb,
       stream>>>(q, k, v, a.bias, g, a.lse, ca, cb, cc, a.cdbias, a.stats,
                 static_cast<T*>(a.ck), static_cast<T*>(a.cv), a.cbias, a.nq,
                 a.nk, a.heads, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.have_null) return err;
  null_reduce_kernel<<<a.heads, kThreads, 0, stream>>>(
      a.null_part, a.cnk, a.cnv, a.cnb, a.b * qtiles, a.heads, a.d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.d <= 16) return launch<T, 1, 4>(a, s);
  if (a.d <= 32) return launch<T, 2, 4>(a, s);
  if (a.d <= 64) return launch<T, 4, 4>(a, s);
  return launch<T, 8, 2>(a, s);  // 32-row streamed tiles
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q, k_pre, v, g and the
// cotangents cdq/cdk/cdv share the dtype; bias, cdbias and cbias are
// (b, H, nk) fp32 or all null; the null-token operands (nullk/nullv in the
// dtype, null_bias and the cotangents cdnullk/cdnullv (H, d) and
// cdnull_bias (H,) fp32) may be null when have_null is 0.  `stats` is a
// (b, H, nq, 3) fp32 workspace, `null_part` one of b·ceil(nq/64)·H·(2d+1)
// floats.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_so_bwd2_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias,
    const void* g, const void* lse, const void* cdq, const void* cdk,
    const void* cdv, const void* cdbias, const void* cdnullk,
    const void* cdnullv, const void* cdnull_bias, void* cq, void* ck,
    void* cv, void* cg, void* cbias, void* stats, void* null_part,
    void* cnullk, void* cnullv, void* cnull_bias, int b, int nq, int nk,
    int heads, int d, int have_null, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || d <= 0 || d > 128 ||
      (bias == nullptr) != (cbias == nullptr) ||
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
  a.bias = static_cast<const float*>(bias);
  a.nullk = nullk;
  a.nullv = nullv;
  a.null_bias = static_cast<const float*>(null_bias);
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.ca = cdq;
  a.cb = cdk;
  a.cc = cdv;
  a.cdbias = static_cast<const float*>(cdbias);
  a.ce = static_cast<const float*>(cdnullk);
  a.cf = static_cast<const float*>(cdnullv);
  a.ch = static_cast<const float*>(cdnull_bias);
  a.cq = cq;
  a.ck = ck;
  a.cv = cv;
  a.cg = cg;
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
  a.d = d;
  a.have_null = have_null;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
