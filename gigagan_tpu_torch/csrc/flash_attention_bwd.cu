// Split-heads flash attention backward from the saved log-sum-exp (kernel
// K6b) on CUDA cores: the route for float32 and for head dims other than 64
// and 128 (bf16 at 64 and 128 runs flash_attention_fused_bwd_tc.cu with one
// head).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention.py (called through `_flash_bwd`,
// the VJP of K6a).  Operands are K6a's prepared ones: q (bh, nq, d),
// k_pre = coeff·k and v (bh, nk, d), bias (bh, nk) fp32.  With the
// cotangent g, K6a's output `out` and its lse (bh, nq), per (b·h):
//
//   A = exp(q·k_preᵀ + bias − lse)   δ = rowsum(g ⊙ out)   dS = A ⊙ (g·vᵀ − δ)
//   dq = dS·k_pre   dk_pre = dSᵀ·q   dv = Aᵀ·g   dbias = colsum(dS)
//
// The TPU kernel folds the prep's chain rule in (dk = coeff·dSᵀq −
// colsum(dS)·k_pre for L2); here it is plain autograd of the prep, which
// gives the same dk from dk_pre and dbias.
//
// What bounds it on an H100: arithmetic, as K6a, and the (nq, nk) maps must
// not reach device memory.  The TPU kernel carries dk/dv across its
// sequential q-tile loop; blocks on the card run in no order, so this is
// the FlashAttention-2 split (as K4):
//
// 1. `flash_bwd_dq_kernel`, query-major: one block per (64-query tile,
//    b·h) forms δ from g and out (written out for step 2) and streams
//    64-key tiles, recomputing A from the saved lse, to accumulate dq.
// 2. `flash_bwd_dkdv_kernel`, key-major: one block per (64-key tile, b·h)
//    streams the query tiles and accumulates dk_pre, dv and the dbias
//    column sum, so nothing is summed across blocks.
//
// No float atomics: the result is deterministic.  A and dS are rounded to
// the operand dtype before the products, as the TPU kernel casts them for
// the MXU; logits and row statistics stay fp32.  Simple first version:
// CUDA-core FMAs, no tensor cores, no TMA.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ g, const T* __restrict__ out,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int nq, int nk, int d) {
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
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d + (size_t)q0 * d;
  const size_t koff = bh * nk * d;
  const float* bias_b = bias + bh * nk;
  const size_t row0 = bh * nq + q0;

  load_tile(qs, q + qoff, nq - q0, d, d, ds);
  load_tile(gs, g + qoff, nq - q0, d, d, ds);
  __syncthreads();

  float lse_r[kRpt], del[kRpt], acc[kRpt][DC];
  zero(acc);
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    const bool valid = q0 + row < nq;
    lse_r[i] = valid ? lse[row0 + row] : INFINITY;  // exp(s - inf) = 0
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (valid && dd < d) {
        part += gs[row * ds + dd] * to_f32(out[qoff + (size_t)row * d + dd]);
      }
    }
    del[i] = half_warp_sum(part);
    if (valid && tx == 0) delta[row0 + row] = del[i];
  }

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // previous key tile consumed
    load_tile(ks, k + koff + (size_t)k0 * d, nk - k0, d, d, ds);
    load_tile(vs, v + koff + (size_t)k0 * d, nk - k0, d, d, ds);
    __syncthreads();

    float s[kRpt][kCpt], da[kRpt][kCpt];
    zero(s);
    zero(da);
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
          const float p = expf(s[i][j] + bias_b[key] - lse_r[i]);
          dsv = p * (da[i][j] - del[i]);
        }
        prow[tx + kLanes * j] = round_to<T>(dsv);
      }
    }
    __syncwarp();
    tile_mm<DC>(acc, ps, ks, ds, d);
    __syncwarp();  // the dS tile is consumed before the next overwrite
  }
  store_rows<T, DC>(dq + qoff, acc, nq - q0, d);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dbias, int nq,
                      int nk, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* ks = smem;                    // (64, ds) this block's keys
  float* vs = ks + kTile * ds;         // (64, ds)
  float* qs = vs + kTile * ds;         // (64, ds) current query tile
  float* gs = qs + kTile * ds;         // (64, ds)
  float* pt = gs + kTile * ds;         // (64 keys, 64 queries) A
  float* dst = pt + kTile * kTile;     // (64, 64) dS
  float* lse_s = dst + kTile * kTile;  // (64)
  float* del_s = lse_s + kTile;        // (64)

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d;
  const size_t koff = bh * nk * d + (size_t)k0 * d;
  const size_t row0 = bh * nq;

  load_tile(ks, k + koff, nk - k0, d, d, ds);
  load_tile(vs, v + koff, nk - k0, d, d, ds);

  float bk[kRpt], dbias_acc[kRpt], adk[kRpt][DC], adv[kRpt][DC];
  zero(adk);
  zero(adv);
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    bk[i] = key < nk ? bias[bh * nk + key] : 0.f;
    dbias_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();  // previous query tile consumed
    load_tile(qs, q + qoff + (size_t)q0 * d, nq - q0, d, d, ds);
    load_tile(gs, g + qoff + (size_t)q0 * d, nq - q0, d, d, ds);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool valid = q0 + r < nq;
      lse_s[r] = valid ? lse[row0 + q0 + r] : INFINITY;
      del_s[r] = valid ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[kRpt][kCpt], da[kRpt][kCpt];
    zero(s);
    zero(da);
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

  store_rows<T, DC>(dk + koff, adk, nk - k0, d);
  store_rows<T, DC>(dv + koff, adv, nk - k0, d);
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + ty * kRpt + i;
    const float colsum = half_warp_sum(dbias_acc[i]);
    if (key < nk && tx == 0) dbias[bh * nk + key] = colsum;
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
                   const float* bias, const void* g, const void* out,
                   const float* lse, void* dq, void* dk, void* dv,
                   float* dbias, float* delta, int bh, int nq, int nk, int d,
                   cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_kernel<T, DC>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(d));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem(d));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  dq_kernel<<<dim3((nq + kTile - 1) / kTile, bh), kThreads, dq_smem(d),
              stream>>>(qt, kt, vt, bias, gt, static_cast<const T*>(out), lse,
                        static_cast<T*>(dq), delta, nq, nk, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((nk + kTile - 1) / kTile, bh), kThreads, dkdv_smem(d),
                stream>>>(qt, kt, vt, bias, gt, lse, delta,
                          static_cast<T*>(dk), static_cast<T*>(dv), dbias, nq,
                          nk, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const void* g, const void* out,
                     const float* lse, void* dq, void* dk, void* dv,
                     float* dbias, float* delta, int bh, int nq, int nk,
                     int d, cudaStream_t s) {
#define GIGAGAN_K6B_LAUNCH(DC)                                             \
  return launch<T, DC>(q, k, v, bias, g, out, lse, dq, dk, dv, dbias,      \
                       delta, bh, nq, nk, d, s)
  if (d <= 16) GIGAGAN_K6B_LAUNCH(1);
  if (d <= 32) GIGAGAN_K6B_LAUNCH(2);
  if (d <= 64) GIGAGAN_K6B_LAUNCH(4);
  GIGAGAN_K6B_LAUNCH(8);
#undef GIGAGAN_K6B_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `delta` is a (bh, nq) fp32
// workspace.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_bwd_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, const void* out, const void* lse, void* dq, void* dk,
    void* dv, void* dbias, void* delta, int bh, int nq, int nk, int d,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > 128) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  const float* lf = static_cast<const float*>(lse);
  float* dbf = static_cast<float*>(dbias);
  float* delf = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bf, g, out, lf, dq, dk, dv, dbf, delf, bh,
                           nq, nk, d, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bf, g, out, lf, dq, dk, dv, dbf,
                                   delf, bh, nq, nk, d, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
