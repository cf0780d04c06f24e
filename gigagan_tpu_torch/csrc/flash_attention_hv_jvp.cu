// Split-heads attention and its tangent in one kernel (kernel K7a) on CUDA
// cores: the route for fp32 and every head dim but bf16 at 64, which
// flash_attention_hv_jvp_tc.cu takes on the tensor cores.
//
// Replaces the Pallas TPU kernel `_jvp_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_hv.py (called through
// `_jvp_impl`): the jvp of the forward-over-reverse R1 penalty's
// attention.  Operands are prepared as for K6a (q, k̂ = coeff·k, v, bias)
// together with their tangents (tq, t̂k = coeff·tk, tv, tbias (bh, nk)
// fp32).  Per (b·h):
//
//   S = q k̂ᵀ + bias   T = tq k̂ᵀ + q t̂kᵀ + tbias   A = softmax(S)
//   μ = rowsum(A⊙T)   out = A v   tout = (A⊙(T − μ)) v + A tv
//   lse = logsumexp(S)
//
// What bounds it on an H100: arithmetic (three logit-sized products and
// three P·V-sized ones per pass), and the (nq, nk) maps S, T and A must not
// reach device memory.  Design: one 128-thread block per (64-query tile,
// b·h), the thread layout of flash_attention_common.cuh, two passes over
// the key tiles.  Pass 1 forms S and T and keeps an online softmax of S
// together with the running Σ e·T, which gives lse and μ.  Pass 2 forms
// the normalized A = exp(S − m) / Σ e from the row's max m and sum (not
// exp(S − lse): a row whose every key is masked has lse = NEG_INF, where
// the log of its sum is lost in rounding, and would take A = 1 at every key
// instead of 1/nk) and A⊙(T − μ), rounds both to the operand
// dtype (as the TPU kernel casts them for the MXU) and accumulates out and
// tout.  Two passes cost one more round of the logit products, but keep
// tout from the cancellation of Σ A T v − μ Σ A v that a one-pass form
// would need.  Any nk is masked in the kernel.  Shared memory: two staged
// (64, d) query tiles, four (KC, d) key tiles and two (64, KC) maps, with
// KC = 64 keys per tile for d ≤ 64 (137 KB at d = 64) and KC = 32 for
// 64 < d ≤ 128 (152 KB at d = 128).

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int DC, int CPT>
__global__ void __launch_bounds__(kThreads)
hv_jvp_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              const T* __restrict__ tq, const T* __restrict__ tk,
              const T* __restrict__ tv, const float* __restrict__ tbias,
              T* __restrict__ out, T* __restrict__ tout,
              float* __restrict__ lse, int nq, int nk, int d) {
  constexpr int KC = kLanes * CPT;  // keys per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* qs = smem;                // (64, ds)
  float* tqs = qs + kTile * ds;    // (64, ds)
  float* ks = tqs + kTile * ds;    // (KC, ds)
  float* tks = ks + KC * ds;       // (KC, ds)
  float* vs = tks + KC * ds;       // (KC, ds)
  float* tvs = vs + KC * ds;       // (KC, ds)
  float* pa = tvs + KC * ds;       // (64, KC) A
  float* pta = pa + kTile * KC;    // (64, KC) A⊙(T − μ)

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d + (size_t)q0 * d;
  const size_t koff = bh * nk * d;
  const float* bias_b = bias + bh * nk;
  const float* tbias_b = tbias + bh * nk;

  load_tile(qs, q + qoff, nq - q0, d, d, ds);
  load_tile(tqs, tq + qoff, nq - q0, d, d, ds);

  // S and T of one key tile; keys past nk get S = -inf and T = 0
  auto logits = [&](int k0, float (&s)[kRpt][CPT], float (&t)[kRpt][CPT]) {
    zero(s);
    zero(t);
    tile_dot(s, qs, ks, ds, d4);
    tile_dot(t, tqs, ks, ds, d4);
    tile_dot(t, qs, tks, ds, d4);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int key = k0 + tx + kLanes * j;
      const bool ok = key < nk;
      const float b = ok ? bias_b[key] : 0.f;
      const float tb = ok ? tbias_b[key] : 0.f;
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        s[i][j] = ok ? s[i][j] + b : -INFINITY;
        t[i][j] = ok ? t[i][j] + tb : 0.f;
      }
    }
  };

  // pass 1: lse and μ
  float m[kRpt], l[kRpt], lt[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    m[i] = -INFINITY;
    l[i] = lt[i] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += KC) {
    __syncthreads();  // previous key tile consumed (and the q tiles staged)
    load_tile(ks, k + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    load_tile(tks, tk + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    __syncthreads();
    float s[kRpt][CPT], t[kRpt][CPT];
    logits(k0, s, t);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) tile_max = fmaxf(tile_max, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 while m is -inf
      float psum = 0.f, ptsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ptsum += p * t[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      lt[i] = lt[i] * alpha + half_warp_sum(ptsum);
      m[i] = m_new;
    }
  }
  float inv_l[kRpt], mu[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    inv_l[i] = 1.f / l[i];
    mu[i] = lt[i] * inv_l[i];
    const int row = q0 + ty * kRpt + i;
    if (row < nq && tx == 0) lse[bh * nq + row] = m[i] + logf(l[i]);
  }

  // pass 2: out and tout from the normalized A
  float acc_o[kRpt][DC], acc_t[kRpt][DC];
  zero(acc_o);
  zero(acc_t);
  for (int k0 = 0; k0 < nk; k0 += KC) {
    __syncthreads();  // previous key tile consumed
    load_tile(ks, k + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    load_tile(tks, tk + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    load_tile(vs, v + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    load_tile(tvs, tv + koff + (size_t)k0 * d, nk - k0, d, d, ds, KC);
    __syncthreads();
    float s[kRpt][CPT], t[kRpt][CPT];
    logits(k0, s, t);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int r = (ty * kRpt + i) * KC;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float a = expf(s[i][j] - m[i]) * inv_l[i];  // masked keys: 0
        pa[r + tx + kLanes * j] = round_to<T>(a);
        pta[r + tx + kLanes * j] = round_to<T>(a * (t[i][j] - mu[i]));
      }
    }
    __syncwarp();
    tile_mm<DC, CPT>(acc_o, pa, vs, ds, d);
    tile_mm<DC, CPT>(acc_t, pta, vs, ds, d);
    tile_mm<DC, CPT>(acc_t, pa, tvs, ds, d);
    __syncwarp();  // the maps are consumed before the next overwrite
  }
  store_rows<T, DC>(out + qoff, acc_o, nq - q0, d);
  store_rows<T, DC>(tout + qoff, acc_t, nq - q0, d);
}

inline size_t smem_bytes(int d, int kc) {
  return sizeof(float) *
         (size_t)((2 * kTile + 4 * kc) * tile_stride(d) + 2 * kTile * kc);
}

template <typename T, int DC, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const void* tq, const void* tk,
                   const void* tv, const float* tbias, void* out, void* tout,
                   float* lse, int bh, int nq, int nk, int d,
                   cudaStream_t stream) {
  auto kernel = hv_jvp_kernel<T, DC, CPT>;
  const size_t smem = smem_bytes(d, kLanes * CPT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((nq + kTile - 1) / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(tq),
      static_cast<const T*>(tk), static_cast<const T*>(tv), tbias,
      static_cast<T*>(out), static_cast<T*>(tout), lse, nq, nk, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const void* tq, const void* tk,
                     const void* tv, const float* tbias, void* out,
                     void* tout, float* lse, int bh, int nq, int nk, int d,
                     cudaStream_t s) {
#define GIGAGAN_K7A_LAUNCH(DC, CPT)                                        \
  return launch<T, DC, CPT>(q, k, v, bias, tq, tk, tv, tbias, out, tout,   \
                            lse, bh, nq, nk, d, s)
  if (d <= 16) GIGAGAN_K7A_LAUNCH(1, 4);
  if (d <= 32) GIGAGAN_K7A_LAUNCH(2, 4);
  if (d <= 64) GIGAGAN_K7A_LAUNCH(4, 4);
  GIGAGAN_K7A_LAUNCH(8, 2);
#undef GIGAGAN_K7A_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_hv_jvp_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* tq, const void* tk, const void* tv, const void* tbias,
    void* out, void* tout, void* lse, int bh, int nq, int nk, int d,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > 128) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  const float* tbf = static_cast<const float*>(tbias);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bf, tq, tk, tv, tbf, out, tout, lf, bh,
                           nq, nk, d, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bf, tq, tk, tv, tbf, out, tout,
                                   lf, bh, nq, nk, d, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
