// Weight and bank-coefficient gradient of the sample-adaptive 3x3 conv
// (kernel K2) on CUDA cores: the route for fp32 operands and for channel
// counts that are not multiples of 16.  bf16 with ci and co multiples of 16
// runs on the tensor cores (adaptive_conv_bwd_w_tc.cu); the wrapper's rule
// `bwd_w_uses_tensor_cores` picks one.
//
//   C[b, ky, kx, i, o] = Σ_{r,c} x_pad[b, r+ky, c+kx, i] · g[b, r, c, o]
//   dW[n] = Σ_b a[b,n] · C[b]          da[b,n] = ⟨Wₙ, C[b]⟩
//
// Replaces the Pallas TPU kernel `_bwd_w_kernel` in
// gigagan_tpu/ops/pallas/adaptive_conv.py (called through `_bwd_w_pallas`).
//
// Layouts (channels-last, as in the JAX package):
//   x  (b, h, w, ci)      T = float or bf16, the conv's input (mod folded in)
//   g  (b, h, w, co)      T, the output cotangent with demod folded in
//   W  (n, 3, 3, ci, co)  WT = float or bf16, the kernel banks
//   a  (b, n)             float, the softmaxed kernel selection
//   dW (n, 3, 3, ci, co)  float;  da (b, n) float
//
// What bounds it on an H100: the reduction shape swings across the
// generator.  The thin high-res layers (256² × 16 → 16) have a 9·16·16
// output summed over 8·65 536 pixels; the wide low-res ones (4² × 512 → 512)
// a 9·512·512 output summed over 16 pixels per sample.  A grid over
// (ci tile, co tile) alone would leave the card idle on the thin layers, so
// the pixel reduction is split across blocks too:
//
// 1. `corr_partial_kernel`: one 256-thread block per (pixel split, ci tile
//    × co tile, sample).  It walks its split's 8×8 pixel tiles, staging the
//    x tile with its halo (the SAME zero border masked while staging) and
//    the g tile in shared memory, and keeps all 9 taps of its (ci × co)
//    tile in fp32 registers.  It writes one fp32 partial C per block.
// 2. `corr_reduce_kernel`: one thread per (tap, i, o) element adds the
//    partials of each sample in split order, forms dW = Σ_b a·C in fp32,
//    and block-reduces W·C into per-block partials of da.
// 3. `da_reduce_kernel`: one block per (b, n) adds those in block order.
//
// Every sum runs in a fixed order (no float atomics), so the result is
// deterministic.  CUDA-core FMAs, no TMA; the partial C of a wide low-res
// layer does reach device memory (b·9·ci·co floats), which the TPU kernel
// and the tensor-core route avoid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // threads along ci and along co
constexpr int kTH = 8;      // pixel tile rows
constexpr int kTW = 8;      // pixel tile columns
constexpr int kPix = kTH * kTW;
constexpr int kXW = kTW + 2;
constexpr int kXPos = (kTH + 2) * kXW;
constexpr int kMaxBanks = 4;

// CI_T × CO_T channel tile; the thread owns ci li + 16·ii and co lo + 16·oo
template <typename T, int CI_T, int CO_T>
__global__ void __launch_bounds__(kThreads)
corr_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    float* __restrict__ partial, int h, int wd, int ci, int co,
                    int tiles_w, int n_tiles, int tiles_per_split, int splits) {
  constexpr int IPT = CI_T / kLanes;
  constexpr int OPT = CO_T / kLanes;
  __shared__ float xs[kXPos][CI_T];
  __shared__ float gs[kPix][CO_T];

  const int tid = threadIdx.x;
  const int li = tid % kLanes;
  const int lo = tid / kLanes;
  const int split = blockIdx.x;
  const int ci_tiles = (ci + CI_T - 1) / CI_T;
  const int c0 = (blockIdx.y % ci_tiles) * CI_T;
  const int o0 = (blockIdx.y / ci_tiles) * CO_T;
  const int bi = blockIdx.z;
  const T* x_b = x + (size_t)bi * h * wd * ci;
  const T* g_b = g + (size_t)bi * h * wd * co;

  float acc[9][IPT][OPT];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ii = 0; ii < IPT; ++ii)
#pragma unroll
      for (int oo = 0; oo < OPT; ++oo) acc[tap][ii][oo] = 0.f;

  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int ty0 = (t / tiles_w) * kTH;
    const int tx0 = (t % tiles_w) * kTW;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kXPos * CI_T; idx += kThreads) {
      const int c = idx % CI_T;
      const int pos = idx / CI_T;
      const int gy = ty0 + pos / kXW - 1;
      const int gx = tx0 + pos % kXW - 1;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + c < ci) {
        v = to_f32(x_b[((size_t)gy * wd + gx) * ci + c0 + c]);
      }
      xs[pos][c] = v;
    }
    for (int idx = tid; idx < kPix * CO_T; idx += kThreads) {
      const int o = idx % CO_T;
      const int p = idx / CO_T;
      const int gy = ty0 + p / kTW;
      const int gx = tx0 + p % kTW;
      float v = 0.f;
      if (gy < h && gx < wd && o0 + o < co) {
        v = to_f32(g_b[((size_t)gy * wd + gx) * co + o0 + o]);
      }
      gs[p][o] = v;
    }
    __syncthreads();

    for (int p = 0; p < kPix; ++p) {
      const int base = (p / kTW) * kXW + p % kTW;
      float gv[OPT];
#pragma unroll
      for (int oo = 0; oo < OPT; ++oo) gv[oo] = gs[p][lo + kLanes * oo];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int pos = base + (tap / 3) * kXW + tap % 3;
        float xv[IPT];
#pragma unroll
        for (int ii = 0; ii < IPT; ++ii) xv[ii] = xs[pos][li + kLanes * ii];
#pragma unroll
        for (int ii = 0; ii < IPT; ++ii)
#pragma unroll
          for (int oo = 0; oo < OPT; ++oo)
            acc[tap][ii][oo] = fmaf(xv[ii], gv[oo], acc[tap][ii][oo]);
      }
    }
  }

  float* out = partial + ((size_t)bi * splits + split) * 9 * ci * co;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ii = 0; ii < IPT; ++ii)
#pragma unroll
      for (int oo = 0; oo < OPT; ++oo) {
        const int i = c0 + li + kLanes * ii;
        const int o = o0 + lo + kLanes * oo;
        if (i < ci && o < co) {
          out[((size_t)tap * ci + i) * co + o] = acc[tap][ii][oo];
        }
      }
}

// Sum of v over the block, in a fixed order; the result is in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  }
  return s;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
corr_reduce_kernel(const float* __restrict__ partial, const WT* __restrict__ w,
                   const float* __restrict__ a, float* __restrict__ dw,
                   float* __restrict__ da_partial, int b, int splits, int n,
                   long elems) {
  __shared__ float red[kThreads / 32];
  const long e = (long)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = e < elems;
  float wv[kMaxBanks], dw_acc[kMaxBanks];
#pragma unroll
  for (int k = 0; k < kMaxBanks; ++k) {
    wv[k] = (valid && k < n) ? to_f32(w[(size_t)k * elems + e]) : 0.f;
    dw_acc[k] = 0.f;
  }
  for (int bi = 0; bi < b; ++bi) {
    float c = 0.f;
    if (valid) {
      const float* p = partial + (size_t)bi * splits * elems + e;
      for (int s = 0; s < splits; ++s) c += p[(size_t)s * elems];
    }
#pragma unroll
    for (int k = 0; k < kMaxBanks; ++k) {
      if (k < n) {
        dw_acc[k] = fmaf(a[bi * n + k], c, dw_acc[k]);
        const float s = block_sum(wv[k] * c, red);
        if (threadIdx.x == 0) {
          da_partial[((size_t)blockIdx.x * b + bi) * n + k] = s;
        }
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < kMaxBanks; ++k)
      if (k < n) dw[(size_t)k * elems + e] = dw_acc[k];
  }
}

// da[b, n] = Σ over reduce blocks of da_partial, one block per (b, n)
__global__ void __launch_bounds__(kThreads)
da_reduce_kernel(const float* __restrict__ da_partial, float* __restrict__ da,
                 int bn, int blocks) {
  __shared__ float red[kThreads / 32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int k = threadIdx.x; k < blocks; k += kThreads) {
    s += da_partial[(size_t)k * bn + j];
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) da[j] = s;
}

struct Plan {
  int ci_t, co_t, tiles_w, n_tiles, tiles_per_split, splits, reduce_blocks;
  long elems;
};

inline Plan plan_for(int b, int h, int wd, int ci, int co, int sms) {
  Plan p;
  p.ci_t = ci <= 16 ? 16 : 32;
  p.co_t = co <= 16 ? 16 : 32;
  p.tiles_w = (wd + kTW - 1) / kTW;
  p.n_tiles = ((h + kTH - 1) / kTH) * p.tiles_w;
  const long base = (long)b * ((ci + p.ci_t - 1) / p.ci_t) *
                    ((co + p.co_t - 1) / p.co_t);
  // about four waves of blocks: the split count fills the card when the
  // channel tiles alone do not
  long splits = (4L * sms + base - 1) / base;
  if (splits > p.n_tiles) splits = p.n_tiles;
  if (splits < 1) splits = 1;
  p.tiles_per_split = (int)((p.n_tiles + splits - 1) / splits);
  p.splits = (p.n_tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  p.elems = 9L * ci * co;
  p.reduce_blocks = (int)((p.elems + kThreads - 1) / kThreads);
  return p;
}

template <typename T, int CI_T, int CO_T>
cudaError_t launch_partial(const void* x, const void* g, float* partial,
                           int b, int h, int wd, int ci, int co,
                           const Plan& p, cudaStream_t stream) {
  const dim3 grid(p.splits,
                  ((ci + CI_T - 1) / CI_T) * ((co + CO_T - 1) / CO_T), b);
  corr_partial_kernel<T, CI_T, CO_T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, h, wd, ci,
      co, p.tiles_w, p.n_tiles, p.tiles_per_split, p.splits);
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t run(const void* x, const void* g, const void* w, const float* a,
                float* dw, float* da, float* partial, float* da_partial,
                int b, int h, int wd, int ci, int co, int n, const Plan& p,
                cudaStream_t stream) {
  cudaError_t err;
  if (p.ci_t == 16 && p.co_t == 16) {
    err = launch_partial<T, 16, 16>(x, g, partial, b, h, wd, ci, co, p, stream);
  } else if (p.ci_t == 16) {
    err = launch_partial<T, 16, 32>(x, g, partial, b, h, wd, ci, co, p, stream);
  } else if (p.co_t == 16) {
    err = launch_partial<T, 32, 16>(x, g, partial, b, h, wd, ci, co, p, stream);
  } else {
    err = launch_partial<T, 32, 32>(x, g, partial, b, h, wd, ci, co, p, stream);
  }
  if (err != cudaSuccess) return err;
  corr_reduce_kernel<WT><<<p.reduce_blocks, kThreads, 0, stream>>>(
      partial, static_cast<const WT*>(w), a, dw, da_partial, b, p.splits, n,
      p.elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  da_reduce_kernel<<<b * n, kThreads, 0, stream>>>(da_partial, da, b * n,
                                                    p.reduce_blocks);
  return cudaGetLastError();
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace

// Workspace the call needs, in floats: the partial correlations and the
// per-block partials of da.  Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_bwd_w_simt_workspace(
    int b, int h, int wd, int ci, int co, int n, int device,
    long* partial_floats, long* da_partial_floats) {
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (b <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 || n <= 0) {
    return cudaErrorInvalidValue;
  }
  const Plan p = plan_for(b, h, wd, ci, co, sms);
  *partial_floats = (long)b * p.splits * p.elems;
  *da_partial_floats = (long)p.reduce_blocks * b * n;
  return cudaSuccess;
}

// dtype codes: 0 = float32, 1 = bfloat16 (x and g share x_dtype).  The
// workspaces must hold what gigagan_adaptive_conv_bwd_w_simt_workspace
// says.
// Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_bwd_w_simt(
    const void* x, const void* g, const void* w, const void* a, void* dw,
    void* da, void* partial, void* da_partial, int b, int h, int wd, int ci,
    int co, int n, int x_dtype, int w_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (b <= 0 || b > 65535 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 ||
      n <= 0 || n > kMaxBanks || b * n > 65535) {
    return cudaErrorInvalidValue;
  }
  const Plan p = plan_for(b, h, wd, ci, co, sms);
  const float* af = static_cast<const float*>(a);
  float* dwf = static_cast<float*>(dw);
  float* daf = static_cast<float*>(da);
  float* pf = static_cast<float*>(partial);
  float* dpf = static_cast<float*>(da_partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) {
    return run<float, float>(x, g, w, af, dwf, daf, pf, dpf, b, h, wd, ci, co,
                             n, p, s);
  }
  if (x_dtype == 1 && w_dtype == 0) {
    return run<__nv_bfloat16, float>(x, g, w, af, dwf, daf, pf, dpf, b, h, wd,
                                     ci, co, n, p, s);
  }
  if (x_dtype == 1 && w_dtype == 1) {
    return run<__nv_bfloat16, __nv_bfloat16>(x, g, w, af, dwf, daf, pf, dpf, b,
                                             h, wd, ci, co, n, p, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
