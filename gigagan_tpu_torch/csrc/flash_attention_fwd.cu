// Split-heads flash attention forward (kernel K6a) on CUDA cores: the route
// for float32 and for head dims other than 64 and 128 (bf16 at 64 and 128
// runs flash_attention_fused_fwd_tc.cu with one head).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention.py (called through
// `_flash_fwd_impl`).  Operands are PREPARED by the caller as `_prep`
// prepares them (ops/kernels/flash_attention.py `prep_split`): heads folded
// into batch, q (bh, nq, d), k_pre = coeff·k and v (bh, nk, d), and one fp32
// bias row (bh, nk) holding −scale·|k|² for L2-distance similarity (0 for
// dot product) and NEG_INF at masked keys.  Per (b·h):
//
//   S = q·k_preᵀ + bias    out = softmax(S)·v    lse = logsumexp(S)
//
// What bounds it on an H100: at the discriminator's shapes (nq = 1024 and
// 256, nk = nq + 1 with the null token, d = 64, b·h = 512-1024) the two
// products are 4·nq·nk·d FLOPs per (b·h) against (nq + 2·nk)·d operand
// elements, so it is arithmetic-bound; the (nq, nk) map must not reach
// device memory.  Design: one 128-thread block per (64-query tile, b·h);
// K/V stream through shared memory in 64-key tiles with an online softmax
// (running max m, sum l, fp32 accumulator).  Each thread owns an 8-row ×
// 4-key tile of the logits and an 8-row × d/16 tile of the output; the 16
// threads of a row are one half-warp, so row max/sum are shuffles and the
// P tile passes through shared memory with only a warp barrier.  P is
// rounded to v's dtype for the P·V product (as the TPU kernel casts it for
// the MXU); logits and statistics stay fp32.  Any nq, nk (the path has
// nk = 1025 and 257) is masked in the kernel.
//
// Simple first version: CUDA-core FMAs, no tensor cores, no TMA.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int nq, int nk,
                 int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = tile_stride(d);
  const int d4 = round4(d) / 4;
  float* qs = smem;               // (64, ds)
  float* ks = qs + kTile * ds;    // (64, ds)
  float* vs = ks + kTile * ds;    // (64, ds)
  float* ps = vs + kTile * ds;    // (64, 64) P tile

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const size_t qoff = bh * nq * d;
  const size_t koff = bh * nk * d;
  const float* bias_b = bias + bh * nk;

  load_tile(qs, q + qoff + (size_t)q0 * d, nq - q0, d, d, ds);

  float m[kRpt], l[kRpt], acc[kRpt][DC];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // previous key tile consumed (and the q tile staged)
    load_tile(ks, k + koff + (size_t)k0 * d, nk - k0, d, d, ds);
    load_tile(vs, v + koff + (size_t)k0 * d, nk - k0, d, d, ds);
    __syncthreads();

    float s[kRpt][kCpt];
    zero(s);
    tile_dot(s, qs, ks, ds, d4);

    // online softmax update; P (rounded to v's dtype) goes to shared memory
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const int key = k0 + tx + kLanes * j;
        s[i][j] = key < nk ? s[i][j] + bias_b[key] : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // finite from the first tile on: it holds key 0, bias is finite
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 while m is -inf
      float psum = 0.f;
      float* prow = ps + (ty * kRpt + i) * kTile;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked keys: 0
        psum += p;
        prow[tx + kLanes * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();
    tile_mm<DC>(acc, ps, vs, ds, d);
    __syncwarp();  // P tile consumed before the next overwrite
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + ty * kRpt + i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] *= inv;
    if (row < nq && tx == 0) lse[bh * nq + row] = m[i] + logf(l[i]);
  }
  store_rows<T, DC>(out + qoff + (size_t)q0 * d, acc, nq - q0, d);
}

inline size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(3 * kTile * tile_stride(d) + kTile * kTile);
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int bh, int nq,
                   int nk, int d, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(d));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((nq + kTile - 1) / kTile, bh), kThreads, smem_bytes(d),
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), bias, static_cast<T*>(out),
                     lse, nq, nk, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, void* out, float* lse, int bh, int nq,
                     int nk, int d, cudaStream_t s) {
  if (d <= 16) return launch<T, 1>(q, k, v, bias, out, lse, bh, nq, nk, d, s);
  if (d <= 32) return launch<T, 2>(q, k, v, bias, out, lse, bh, nq, nk, d, s);
  if (d <= 64) return launch<T, 4>(q, k, v, bias, out, lse, bh, nq, nk, d, s);
  return launch<T, 8>(q, k, v, bias, out, lse, bh, nq, nk, d, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_fwd_simt(const void* q, const void* k,
                                                const void* v,
                                                const void* bias, void* out,
                                                void* lse, int bh, int nq,
                                                int nk, int d, int dtype,
                                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d > 128) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bf, out, lf, bh, nq, nk, d, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bf, out, lf, bh, nq, nk, d, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
