// Fused-heads attention backward from the saved log-sum-exp (kernel K4).
//
// Replaces the Pallas TPU kernel `_bwd_sc_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_so.py (called through
// `_bwd_sc_impl`, the VJP of the forward K3).  Operands are K3's PREPARED
// ones: q, k_pre = coeff·k, v (b, n, H·d); bias (b, H, nk) f32 or null;
// the null token's nullk_pre / nullv (H, d) and null_bias (H,) f32.  With
// the cotangent g, K3's output `out` and its lse (b, H, nq), per head:
//
//   P = exp(q·k_preᵀ + bias − lse)     Pⁿ = exp(q·nullk_pre + null_bias − lse)
//   dA = g·vᵀ   δ = rowsum(g ⊙ out)   dS = P ⊙ (dA − δ)   dSⁿ = Pⁿ (g·nullv − δ)
//   dq = dS·k_pre + dSⁿ nullk_pre      dk_pre = dSᵀ·q     dv = Pᵀ·g
//   dbias = colsum(dS)   and, summed over batch and rows,
//   dnullk_pre = Σ dSⁿ q   dnullv = Σ Pⁿ g   dnull_bias = Σ dSⁿ
//
// What bounds it on an H100: like the forward it is arithmetic-bound at the
// discriminator's shapes (n = 1024 and 256, d = 64, batch 64-128), and the
// (n, n) maps must not reach device memory.  The design is the
// FlashAttention-2 split:
//
// 1. `attn_bwd_dq_kernel`, query-major: one block per (64-query tile, head,
//    sample).  It forms δ from g and out (written out for step 2), the null
//    column, and streams 64-key tiles, recomputing P from the saved lse, to
//    accumulate dq in registers.  It writes per-block partials of the null
//    token's gradients.
// 2. `attn_bwd_dkdv_kernel`, key-major: one block per (64-key tile, head,
//    sample) streams the query tiles and accumulates dk_pre, dv and the
//    dbias column sum, so nothing is summed across blocks.
// 3. `null_reduce_kernel`: the null partials added in a fixed order.
//
// No float atomics anywhere: the result is deterministic.  P and dS are
// rounded to the operand dtype before the products, as the TPU kernel casts
// them for the MXU; logits and row statistics stay fp32.  CUDA-core FMAs,
// no tensor cores, no TMA: the route for fp32 and for head dims other than
// 64 and 128 (flash_attention_fused_bwd_tc.cu takes bf16 at those).

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ nullk, const T* __restrict__ nullv,
                   const float* __restrict__ null_bias,
                   const T* __restrict__ g, const T* __restrict__ out,
                   const float* __restrict__ lse, T* __restrict__ dq,
                   float* __restrict__ delta, float* __restrict__ null_part,
                   int nq, int nk, int heads, int d, int have_null) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* qs = smem;               // (64, ds)
  float* gs = qs + kTile * ds;    // (64, ds)
  float* ks = gs + kTile * ds;    // (64, ds)
  float* vs = ks + kTile * ds;    // (64, ds)
  float* ps = vs + kTile * ds;    // (64, 64) dS tile

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * kTile;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t hd = (size_t)heads * d;
  const size_t qoff = (size_t)bi * nq * hd + (size_t)hh * d;
  const size_t koff = (size_t)bi * nk * hd + (size_t)hh * d;
  const float* bias_b =
      bias ? bias + ((size_t)bi * heads + hh) * nk : nullptr;
  const size_t row0 = ((size_t)bi * heads + hh) * nq;

  load_tile(qs, q + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
  load_tile(gs, g + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
  __syncthreads();

  float lse_r[kRpt], del[kRpt], acc[kRpt][DC];
  float pk[DC], pv[DC], pb = 0.f;
#pragma unroll
  for (int c = 0; c < DC; ++c) pk[c] = pv[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    const int grow = q0 + row;
    const bool valid = grow < nq;
    lse_r[i] = valid ? lse[row0 + grow] : INFINITY;  // exp(s - inf) = 0
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (valid && dd < d) {
        part += gs[row * ds + dd] * to_f32(out[qoff + (size_t)grow * hd + dd]);
      }
    }
    del[i] = half_warp_sum(part);
    if (valid && tx == 0) delta[row0 + grow] = del[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    if (have_null) {
      const T* nk_h = nullk + (size_t)hh * d;
      const T* nv_h = nullv + (size_t)hh * d;
      float sn = 0.f, dan = 0.f;
      for (int dd = tx; dd < d; dd += kLanes) {
        sn += qs[row * ds + dd] * to_f32(nk_h[dd]);
        dan += gs[row * ds + dd] * to_f32(nv_h[dd]);
      }
      sn = half_warp_sum(sn) + null_bias[hh];
      dan = half_warp_sum(dan);
      const float pn = valid ? expf(sn - lse_r[i]) : 0.f;
      const float dsn = pn * (dan - del[i]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dd = tx + kLanes * c;
        if (dd < d) {
          acc[i][c] = dsn * to_f32(nk_h[dd]);
          pk[c] += dsn * qs[row * ds + dd];
          pv[c] += pn * gs[row * ds + dd];
        }
      }
      pb += dsn;
    }
  }

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // previous key tile consumed
    load_tile(ks, k + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
    load_tile(vs, v + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
    __syncthreads();

    float s[kRpt][kCpt], da[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCpt; ++j) s[i][j] = da[i][j] = 0.f;
    tile_dot(s, qs, ks, ds, d4);
    tile_dot(da, gs, vs, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float* prow = ps + (ty * kRpt + i) * kTile;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const int key = k0 + tx + kLanes * j;
        float dsv = 0.f;
        if (key < nk) {
          const float p =
              expf(s[i][j] + (bias_b ? bias_b[key] : 0.f) - lse_r[i]);
          dsv = p * (da[i][j] - del[i]);
        }
        prow[tx + kLanes * j] = round_to<T>(dsv);
      }
    }
    __syncwarp();
    tile_mm<DC>(acc, ps, ks, ds, d);
    __syncwarp();  // the dS tile is consumed before the next overwrite
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int grow = q0 + ty * kRpt + i;
    if (grow >= nq) continue;
    T* drow = dq + qoff + (size_t)grow * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) drow[dd] = from_f32<T>(acc[i][c]);
    }
  }
  if (have_null) {
    const int slot = bi * gridDim.x + blockIdx.x;
    write_null_partial<DC>(pk, pv, pb, ps, null_part +
                           ((size_t)slot * heads + hh) * (2 * d + 1), d);
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dbias, int nq,
                     int nk, int heads, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* ks = smem;               // (64, ds) this block's keys
  float* vs = ks + kTile * ds;    // (64, ds)
  float* qs = vs + kTile * ds;    // (64, ds) current query tile
  float* gs = qs + kTile * ds;    // (64, ds)
  float* pt = gs + kTile * ds;    // (64 keys, 64 queries) P
  float* dst = pt + kTile * kTile;  // (64, 64) dS
  float* lse_s = dst + kTile * kTile;  // (64)
  float* del_s = lse_s + kTile;        // (64)

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int k0 = blockIdx.x * kTile;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t hd = (size_t)heads * d;
  const size_t qoff = (size_t)bi * nq * hd + (size_t)hh * d;
  const size_t koff = (size_t)bi * nk * hd + (size_t)hh * d;
  const size_t row0 = ((size_t)bi * heads + hh) * nq;

  load_tile(ks, k + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);
  load_tile(vs, v + koff + (size_t)k0 * hd, nk - k0, hd, d, ds);

  float bk[kRpt], dbias_acc[kRpt], adk[kRpt][DC], adv[kRpt][DC];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    bk[i] = (bias && key < nk)
                ? bias[((size_t)bi * heads + hh) * nk + key] : 0.f;
    dbias_acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();  // previous query tile consumed
    load_tile(qs, q + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
    load_tile(gs, g + qoff + (size_t)q0 * hd, nq - q0, hd, d, ds);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool valid = q0 + r < nq;
      lse_s[r] = valid ? lse[row0 + q0 + r] : INFINITY;
      del_s[r] = valid ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[kRpt][kCpt], da[kRpt][kCpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCpt; ++j) s[i][j] = da[i][j] = 0.f;
    tile_dot(s, ks, qs, ds, d4);
    tile_dot(da, vs, gs, ds, d4);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = ty * kRpt + i;
      const bool key_ok = k0 + row < nk;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const int col = tx + kLanes * j;
        float p = 0.f, dsv = 0.f;
        if (key_ok) {
          p = expf(s[i][j] + bk[i] - lse_s[col]);
          dsv = p * (da[i][j] - del_s[col]);
        }
        dbias_acc[i] += dsv;
        pt[row * kTile + col] = round_to<T>(p);
        dst[row * kTile + col] = round_to<T>(dsv);
      }
    }
    __syncwarp();
    tile_mm<DC>(adv, pt, gs, ds, d);
    tile_mm<DC>(adk, dst, qs, ds, d);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const float colsum = half_warp_sum(dbias_acc[i]);
    if (key >= nk) continue;
    T* krow = dk + koff + (size_t)key * hd;
    T* vrow = dv + koff + (size_t)key * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) {
        krow[dd] = from_f32<T>(adk[i][c]);
        vrow[dd] = from_f32<T>(adv[i][c]);
      }
    }
    if (dbias && tx == 0) {
      dbias[((size_t)bi * heads + hh) * nk + key] = colsum;
    }
  }
}

inline size_t dq_smem(int d) {
  return sizeof(float) * (size_t)(4 * kTile * tile_stride(d) + kTile * kTile);
}

inline size_t dkdv_smem(int d) {
  return sizeof(float) *
         (size_t)(4 * kTile * tile_stride(d) + 2 * kTile * kTile + 2 * kTile);
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const void* nullk, const void* nullv,
                   const float* null_bias, const void* g, const void* out,
                   const float* lse, void* dq, void* dk, void* dv,
                   float* dbias, float* delta, float* null_part, float* dnk,
                   float* dnv, float* dnb, int b, int nq, int nk, int heads,
                   int d, int have_null, cudaStream_t stream) {
  auto dq_kernel = attn_bwd_dq_kernel<T, DC>;
  auto dkdv_kernel = attn_bwd_dkdv_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(d));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem(d));
  if (err != cudaSuccess) return err;
  const int qtiles = (nq + kTile - 1) / kTile;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  dq_kernel<<<dim3(qtiles, heads, b), kThreads, dq_smem(d), stream>>>(
      qt, kt, vt, bias, static_cast<const T*>(nullk),
      static_cast<const T*>(nullv), null_bias, gt, static_cast<const T*>(out),
      lse, static_cast<T*>(dq), delta, null_part, nq, nk, heads, d, have_null);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((nk + kTile - 1) / kTile, heads, b), kThreads,
                dkdv_smem(d), stream>>>(qt, kt, vt, bias, gt, lse, delta,
                                        static_cast<T*>(dk),
                                        static_cast<T*>(dv), dbias, nq, nk,
                                        heads, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || !have_null) return err;
  null_reduce_kernel<<<heads, kThreads, 0, stream>>>(null_part, dnk, dnv, dnb,
                                                      b * qtiles, heads, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const void* nullk, const void* nullv,
                     const float* null_bias, const void* g, const void* out,
                     const float* lse, void* dq, void* dk, void* dv,
                     float* dbias, float* delta, float* null_part, float* dnk,
                     float* dnv, float* dnb, int b, int nq, int nk, int heads,
                     int d, int have_null, cudaStream_t s) {
#define GIGAGAN_K4_LAUNCH(DC)                                                 \
  return launch<T, DC>(q, k, v, bias, nullk, nullv, null_bias, g, out, lse,   \
                       dq, dk, dv, dbias, delta, null_part, dnk, dnv, dnb, b, \
                       nq, nk, heads, d, have_null, s)
  if (d <= 16) GIGAGAN_K4_LAUNCH(1);
  if (d <= 32) GIGAGAN_K4_LAUNCH(2);
  if (d <= 64) GIGAGAN_K4_LAUNCH(4);
  GIGAGAN_K4_LAUNCH(8);
#undef GIGAGAN_K4_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `bias`/`dbias` may be null (dot
// product); the null-token pointers may be null when have_null is 0.
// `delta` is a (b, H, nq) fp32 workspace, `null_part` one of
// b·ceil(nq/64)·H·(2d+1) floats.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_fused_bwd_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias,
    const void* g, const void* out, const void* lse, void* dq, void* dk,
    void* dv, void* dbias, void* delta, void* null_part, void* dnullk,
    void* dnullv, void* dnull_bias, int b, int nq, int nk, int heads, int d,
    int have_null, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || d <= 0 || d > 128 || (bias == nullptr) != (dbias == nullptr) ||
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
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bf, nullk, nullv, nbf, g, out, lf, dq, dk,
                           dv, dbf, delf, npf, dnk, dnv, dnb, b, nq, nk, heads,
                           d, have_null, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bf, nullk, nullv, nbf, g, out, lf,
                                   dq, dk, dv, dbf, delf, npf, dnk, dnv, dnb, b,
                                   nq, nk, heads, d, have_null, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
