// Fused sample-adaptive modulated 3x3 conv, forward (kernel K1).
//
//   out[b] = demod[b] ⊙ conv3x3_SAME(x_mod[b], Σₙ a[b,n]·Wₙ)
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// gigagan_tpu/ops/pallas/adaptive_conv.py (called through `_fwd_call`).
//
// Layouts (channels-last, as in the JAX package):
//   x_mod (b, h, w, ci)      T = float or bf16, (1+mod) already folded in
//   W     (n, 3, 3, ci, co)  WT = float or bf16, the kernel banks as stored
//   a     (b, n)             float, softmaxed kernel selection
//   demod (b, co)            float, output scale (ones when demod is off)
//   out   (b, h, w, co)      T
//
// What bounds it on an H100: at the generator's shapes the conv is
// 2·h·w·9·ci·co FLOPs per sample against a few MB of activations, i.e.
// arithmetic-bound, and the per-sample weight is the only sample-specific
// operand.  The reference materialises b·9·ci·co mixed weights in device
// memory for a grouped conv; this kernel never does.  Each block owns one
// (sample, pixel tile, co tile): it mixes its (ci tile, co tile) slice of
// the n banks with a[b,:] in fp32 into shared memory, rounds the mix to the
// operand dtype (as the TPU kernel rounds it for the MXU), and accumulates
// the 9 shifted products in fp32 registers.  The SAME border is masked while
// the input tile is staged, so no padded copy of x exists.  demod is applied
// in fp32 before the final cast.
//
// Simple first version: CUDA-core FMAs (no tensor cores, no TMA), a
// 256-thread block computing a (pixels × co) register tile of 4×4 per
// thread, ci streamed in tiles of 16.  Blocks of one sample re-mix the same
// weight slice once per pixel tile — redundant but weight-sized work next to
// the conv; caching the mix is later work.  Ragged ci/co (16, 32) and tiny
// maps (4×4) are handled by masking; three tile shapes keep thin-co layers
// from idling threads.
//
// Small maps with wide channels (4²-16² × 512 at the generator's low-res
// stages) give too few (sample, pixel tile, co tile) blocks to fill 132 SMs,
// and each would walk all of ci alone.  There the ci range is split across
// blocks: each writes an fp32 partial sum to a caller-allocated workspace,
// and a second kernel adds the partials in a fixed order (deterministic),
// applies demod and casts.

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

constexpr int kThreads = 256;
constexpr int kCiTile = 16;
constexpr int kCpt = 4;  // output channels per thread
constexpr int kPpt = 4;  // pixels per thread

template <typename T, typename WT, int TH, int TW, int CO_T>
__global__ void __launch_bounds__(kThreads)
adaptive_conv_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                         const float* __restrict__ a,
                         const float* __restrict__ demod,
                         T* __restrict__ out, float* __restrict__ partial,
                         int b, int h, int wd, int ci, int co, int n,
                         int tiles_w, int ci_per_split) {
  constexpr int CO_LANES = CO_T / kCpt;
  constexpr int PIX = TH * TW;
  constexpr int PIX_LANES = PIX / kPpt;
  static_assert(CO_LANES * PIX_LANES == kThreads, "thread layout");
  constexpr int XW = TW + 2;
  constexpr int XPOS = (TH + 2) * XW;

  __shared__ float xs[kCiTile][XPOS];
  __shared__ float ws[9][kCiTile][CO_T];

  const int tid = threadIdx.x;
  const int bi = blockIdx.z % b;
  const int split = blockIdx.z / b;
  const int c_begin = split * ci_per_split;
  const int c_end = min(ci, c_begin + ci_per_split);
  const int co0 = blockIdx.y * CO_T;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int cl = tid % CO_LANES;
  const int pl = tid / CO_LANES;

  int pbase[kPpt];
#pragma unroll
  for (int i = 0; i < kPpt; ++i) {
    const int p = pl + i * PIX_LANES;
    pbase[i] = (p / TW) * XW + (p % TW);
  }

  float acc[kPpt][kCpt];
#pragma unroll
  for (int i = 0; i < kPpt; ++i)
#pragma unroll
    for (int j = 0; j < kCpt; ++j) acc[i][j] = 0.f;

  const float* a_b = a + (size_t)bi * n;
  const T* x_b = x + (size_t)bi * h * wd * ci;
  const size_t bank_stride = (size_t)9 * ci * co;

  for (int c0 = c_begin; c0 < c_end; c0 += kCiTile) {
    // input tile with its 1-pixel halo; outside the map is the SAME zero pad
    for (int idx = tid; idx < kCiTile * XPOS; idx += kThreads) {
      const int c = idx % kCiTile;
      const int pos = idx / kCiTile;
      const int gy = ty0 + pos / XW - 1;
      const int gx = tx0 + pos % XW - 1;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + c < c_end) {
        v = to_f32(x_b[((size_t)gy * wd + gx) * ci + c0 + c]);
      }
      xs[c][pos] = v;
    }
    // this block's slice of the per-sample mixed kernel, fp32 then rounded
    for (int idx = tid; idx < 9 * kCiTile * CO_T; idx += kThreads) {
      const int o = idx % CO_T;
      const int c = (idx / CO_T) % kCiTile;
      const int tap = idx / (CO_T * kCiTile);
      float m = 0.f;
      if (co0 + o < co && c0 + c < c_end) {
        const size_t off = ((size_t)tap * ci + c0 + c) * co + co0 + o;
        for (int k = 0; k < n; ++k) {
          m += a_b[k] * to_f32(w[k * bank_stride + off]);
        }
      }
      ws[tap][c][o] = to_f32(from_f32<T>(m));
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * XW + tap % 3;
#pragma unroll 4
      for (int c = 0; c < kCiTile; ++c) {
        float xv[kPpt], wv[kCpt];
#pragma unroll
        for (int i = 0; i < kPpt; ++i) xv[i] = xs[c][pbase[i] + shift];
#pragma unroll
        for (int j = 0; j < kCpt; ++j) wv[j] = ws[tap][c][cl + j * CO_LANES];
#pragma unroll
        for (int i = 0; i < kPpt; ++i)
#pragma unroll
          for (int j = 0; j < kCpt; ++j)
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPpt; ++i) {
    const int p = pl + i * PIX_LANES;
    const int gy = ty0 + p / TW;
    const int gx = tx0 + p % TW;
    if (gy >= h || gx >= wd) continue;
    const size_t pix = ((size_t)bi * h + gy) * wd + gx;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) {
      const int o = co0 + cl + j * CO_LANES;
      if (o >= co) continue;
      if (partial) {
        partial[((size_t)split * b * h * wd + pix) * co + o] = acc[i][j];
      } else {
        out[pix * co + o] = from_f32<T>(acc[i][j] * demod[(size_t)bi * co + o]);
      }
    }
  }
}

// out = cast(demod ⊙ Σ_split partial[split]), partials added in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
adaptive_conv_reduce_kernel(const float* __restrict__ partial,
                            const float* __restrict__ demod,
                            T* __restrict__ out, int splits, int hw, int co,
                            size_t total) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  const int o = (int)(idx % co);
  const size_t bi = idx / ((size_t)hw * co);
  out[idx] = from_f32<T>(sum * demod[bi * co + o]);
}

struct Tile {
  int th, tw, co_t;
};

// thin output channels get wider pixel tiles so no thread idles
inline Tile tile_for(int co) {
  if (co <= 16) return {16, 16, 16};
  if (co <= 32) return {16, 8, 32};
  return {8, 8, 64};
}

// ci splits so that about two waves of blocks cover the SMs, with at least
// two whole 16-channel tiles per split (below that the extra reduce pass
// costs more than the split saves)
inline int ci_per_split_for(int b, int h, int wd, int ci, int co, int sms) {
  const Tile t = tile_for(co);
  const long blocks = (long)((h + t.th - 1) / t.th) * ((wd + t.tw - 1) / t.tw) *
                      ((co + t.co_t - 1) / t.co_t) * b;
  const int chunks = (ci + kCiTile - 1) / kCiTile;
  long splits = (2L * sms + blocks - 1) / blocks;
  if (splits > chunks / 2) splits = chunks / 2;
  if (splits < 1) splits = 1;
  const int chunks_per_split = (int)((chunks + splits - 1) / splits);
  return chunks_per_split * kCiTile;
}

template <typename T, typename WT, int TH, int TW, int CO_T>
cudaError_t launch(const void* x, const void* w, const float* a,
                   const float* demod, void* out, float* partial, int b,
                   int h, int wd, int ci, int co, int n, int ci_per_split,
                   cudaStream_t stream) {
  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (wd + TW - 1) / TW;
  const int splits = (ci + ci_per_split - 1) / ci_per_split;
  const dim3 grid(tiles_h * tiles_w, (co + CO_T - 1) / CO_T, b * splits);
  adaptive_conv_fwd_kernel<T, WT, TH, TW, CO_T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w), a, demod,
      static_cast<T*>(out), splits > 1 ? partial : nullptr, b, h, wd, ci, co,
      n, tiles_w, ci_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)b * h * wd * co;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  adaptive_conv_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
      partial, demod, static_cast<T*>(out), splits, h * wd, co, total);
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t dispatch(const void* x, const void* w, const float* a,
                     const float* demod, void* out, float* partial, int b,
                     int h, int wd, int ci, int co, int n, int ci_per_split,
                     cudaStream_t stream) {
  const Tile t = tile_for(co);
  if (t.co_t == 16) {
    return launch<T, WT, 16, 16, 16>(x, w, a, demod, out, partial, b, h, wd,
                                     ci, co, n, ci_per_split, stream);
  }
  if (t.co_t == 32) {
    return launch<T, WT, 16, 8, 32>(x, w, a, demod, out, partial, b, h, wd,
                                    ci, co, n, ci_per_split, stream);
  }
  return launch<T, WT, 8, 8, 64>(x, w, a, demod, out, partial, b, h, wd, ci,
                                 co, n, ci_per_split, stream);
}

}  // namespace

// Input channels each block sums over (a multiple of 16); the call needs
// an fp32 workspace of splits·b·h·w·co floats when it is below ci, with
// splits = ceil(ci / ci_per_split).  Returns <= 0 on a CUDA error.
extern "C" int gigagan_adaptive_conv_fwd_ci_per_split(int b, int h, int wd,
                                                      int ci, int co,
                                                      int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return 0;
  }
  return ci_per_split_for(b, h, wd, ci, co, sms);
}

// dtype codes: 0 = float32, 1 = bfloat16.  `partial` may be null when
// ci_per_split >= ci.  Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_fwd_simt(const void* x, const void* w,
                                         const void* a, const void* demod,
                                         void* out, void* partial, int b,
                                         int h, int wd, int ci, int co, int n,
                                         int ci_per_split, int x_dtype,
                                         int w_dtype, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long splits = ci_per_split > 0 ? (ci + ci_per_split - 1) / ci_per_split
                                       : 0;
  if (b <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 || n <= 0 ||
      ci_per_split <= 0 || ci_per_split % kCiTile != 0 ||
      b * splits > 65535 || (co + 15) / 16 > 65535 ||
      (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  float* pf = static_cast<float*>(partial);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(demod);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) {
    return dispatch<float, float>(x, w, af, df, out, pf, b, h, wd, ci, co, n,
                                  ci_per_split, s);
  }
  if (x_dtype == 1 && w_dtype == 0) {
    return dispatch<__nv_bfloat16, float>(x, w, af, df, out, pf, b, h, wd, ci,
                                          co, n, ci_per_split, s);
  }
  if (x_dtype == 1 && w_dtype == 1) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, af, df, out, pf, b, h,
                                                  wd, ci, co, n, ci_per_split,
                                                  s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
