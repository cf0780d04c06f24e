// Fused-heads flash attention forward with an analytic null key/value
// (kernel K3).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_fused.py (called through
// `_fwd_impl`).  Operands are PREPARED by the caller exactly as `_prep_fused`
// prepares them: k_pre = coeff·k, a per-(b, head, key) fp32 bias row
// (−scale·|k|² for L2-distance similarity, absent for dot product), and the
// null token as k_pre/v/bias rows per head.  Then for each head h
//
//   sim  = q·k_preᵀ + bias                        (fp32)
//   null = q·nullk_pre[h] + null_bias[h]          (one extra logit per row)
//   out  = softmax([null, sim]) · [nullv[h]; v],  lse = logsumexp([null, sim])
//
// Layouts: q (b, nq, H·d), k_pre/v (b, nk, H·d) read in place with a row
// stride of H·d (no head transposes); bias (b, H, nk) f32 or null;
// nullk_pre/nullv (H, d); null_bias (H,) f32; out (b, nq, H·d); lse (b, H, nq).
//
// What bounds it on an H100: for the generator's self-attention (n = 1024
// and 256, d = 64) the two products are 4·n²·d FLOPs per (sample, head)
// against 3·n·d operand elements, so it is arithmetic-bound; what must not
// happen is the (n, n) similarity reaching device memory.  Design: one
// 128-thread block per (64-query tile, head, sample); K/V stream through
// shared memory in 64-key tiles with an online softmax (running max m, sum
// l, fp32 accumulator) seeded with the null column: m₀ = null logit, l₀ = 1,
// acc₀ = nullv.  Each thread owns an 8-row × 4-key tile of the logits and an
// 8-row × d/16 tile of the output; the 16 threads that share a row are one
// half-warp, so row max/sum are shuffle reductions and the P tile passes
// through shared memory with only a warp barrier.  P is rounded to v's dtype
// for the P·V product (as the TPU kernel casts it for the MXU); logits and
// statistics stay fp32.  Ragged nq/nk are masked in the kernel.
//
// CUDA-core FMAs, no tensor cores, no TMA: the route for fp32 and for head
// dims other than 64 and 128 (flash_attention_fused_fwd_tc.cu takes bf16 at
// those on the tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 128;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kRpt = 8;       // rows per thread
constexpr int kKpt = 4;       // keys per thread
constexpr int kLanes = 16;    // threads sharing a row (one half-warp)

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// padded row stride of the q/k tiles: float4-aligned, and 4 banks apart so
// a quarter-warp's float4 reads of 8 consecutive rows hit distinct banks
__host__ __device__ inline int qk_stride(int d) { return round4(d) + 4; }

inline size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)(kBQ * qk_stride(d) + kBK * qk_stride(d) + kBK * d +
                  kBQ * kBK);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DC = output columns per thread: the thread owns dims tx + 16·c, c < DC
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fused_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias,
                       const T* __restrict__ nullk,
                       const T* __restrict__ nullv,
                       const float* __restrict__ null_bias,
                       T* __restrict__ out, float* __restrict__ lse, int nq,
                       int nk, int heads, int d, int have_null) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = qk_stride(d);
  const int d4 = round4(d) / 4;
  float* qs = smem;                 // (kBQ, ds)
  float* ks = qs + kBQ * ds;        // (kBK, ds)
  float* vs = ks + kBK * ds;        // (kBK, d)
  float* ps = vs + kBK * d;         // (kBQ, kBK)

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;      // rows ty·8 .. ty·8+7
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t hd = (size_t)heads * d;
  const T* q_b = q + (size_t)bi * nq * hd + (size_t)hh * d;
  const T* k_b = k + (size_t)bi * nk * hd + (size_t)hh * d;
  const T* v_b = v + (size_t)bi * nk * hd + (size_t)hh * d;
  const float* bias_b =
      bias ? bias + ((size_t)bi * heads + hh) * nk : nullptr;

  // q tile, zero-padded in rows (ragged nq) and in columns up to ds
  for (int idx = tid; idx < kBQ * ds; idx += kThreads) {
    const int r = idx / ds;
    const int c = idx % ds;
    float val = 0.f;
    if (q0 + r < nq && c < d) val = to_f32(q_b[(size_t)(q0 + r) * hd + c]);
    qs[idx] = val;
  }
  __syncthreads();

  float m[kRpt], l[kRpt], acc[kRpt][DC];
  if (have_null) {
    // the null token: one analytic extra logit column per row
    const T* nk_h = nullk + (size_t)hh * d;
    const T* nv_h = nullv + (size_t)hh * d;
    const float nb = null_bias[hh];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float* qrow = qs + (ty * kRpt + i) * ds;
      float part = 0.f;
      for (int c = tx; c < d; c += kLanes) part += qrow[c] * to_f32(nk_h[c]);
      m[i] = half_warp_sum(part) + nb;
      l[i] = 1.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dd = tx + kLanes * c;
        acc[i][c] = dd < d ? to_f32(nv_h[dd]) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }
  }

  for (int k0 = 0; k0 < nk; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < kBK * ds; idx += kThreads) {
      const int r = idx / ds;
      const int c = idx % ds;
      float val = 0.f;
      if (k0 + r < nk && c < d) val = to_f32(k_b[(size_t)(k0 + r) * hd + c]);
      ks[idx] = val;
    }
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx % d;
      vs[idx] = k0 + r < nk ? to_f32(v_b[(size_t)(k0 + r) * hd + c]) : 0.f;
    }
    __syncthreads();

    // logits: rows ty·8+i, keys tx + 16·j
    float s[kRpt][kKpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kKpt; ++j) s[i][j] = 0.f;
    for (int c4 = 0; c4 < d4; ++c4) {
      float4 kv[kKpt];
#pragma unroll
      for (int j = 0; j < kKpt; ++j)
        kv[j] = reinterpret_cast<const float4*>(ks + (tx + kLanes * j) * ds)[c4];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(qs + (ty * kRpt + i) * ds)[c4];
#pragma unroll
        for (int j = 0; j < kKpt; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // online softmax update; P (rounded to v's dtype) goes to shared memory
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const int key = k0 + tx + kLanes * j;
        if (key < nk) {
          s[i][j] += bias_b ? bias_b[key] : 0.f;
        } else {
          s[i][j] = -INFINITY;
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 while m is -inf
      float psum = 0.f;
      float* prow = ps + (ty * kRpt + i) * kBK;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked keys: exp(-inf) = 0
        psum += p;
        prow[tx + kLanes * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc += P · V over this key tile
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int dd = tx + kLanes * c;
          vv[jj][c] = dd < d ? vs[(j4 * 4 + jj) * d + dd] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float4 pv =
            reinterpret_cast<const float4*>(ps + (ty * kRpt + i) * kBK)[j4];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[i][c] = fmaf(pv.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(pv.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(pv.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(pv.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();  // P tile consumed before the next overwrite
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + ty * kRpt + i;
    if (row >= nq) continue;
    const float inv = 1.f / l[i];
    T* orow = out + ((size_t)bi * nq + row) * hd + (size_t)hh * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) orow[dd] = from_f32<T>(acc[i][c] * inv);
    }
    if (tx == 0) {
      lse[((size_t)bi * heads + hh) * nq + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const void* nullk, const void* nullv,
                   const float* null_bias, void* out, float* lse, int b,
                   int nq, int nk, int heads, int d, int have_null,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  auto kernel = flash_fused_fwd_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(nullk),
      static_cast<const T*>(nullv), null_bias, static_cast<T*>(out), lse, nq,
      nk, heads, d, have_null);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const void* nullk, const void* nullv,
                     const float* null_bias, void* out, float* lse, int b,
                     int nq, int nk, int heads, int d, int have_null,
                     cudaStream_t s) {
  if (d <= 16)
    return launch<T, 1>(q, k, v, bias, nullk, nullv, null_bias, out, lse, b,
                        nq, nk, heads, d, have_null, s);
  if (d <= 32)
    return launch<T, 2>(q, k, v, bias, nullk, nullv, null_bias, out, lse, b,
                        nq, nk, heads, d, have_null, s);
  if (d <= 64)
    return launch<T, 4>(q, k, v, bias, nullk, nullv, null_bias, out, lse, b,
                        nq, nk, heads, d, have_null, s);
  return launch<T, 8>(q, k, v, bias, nullk, nullv, null_bias, out, lse, b, nq,
                      nk, heads, d, have_null, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `bias` may be null (dot product).
// Returns a cudaError_t.
extern "C" int gigagan_flash_attention_fused_fwd_simt(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias, void* out,
    void* lse, int b, int nq, int nk, int heads, int d, int have_null,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || d <= 0 || d > 128) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  const float* nbf = static_cast<const float*>(null_bias);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bf, nullk, nullv, nbf, out, lf, b, nq, nk,
                           heads, d, have_null, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bf, nullk, nullv, nbf, out, lf, b,
                                   nq, nk, heads, d, have_null, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
