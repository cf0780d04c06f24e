// Fused sample-adaptive modulated 3x3 conv, forward, on Hopper's tensor
// cores (kernel K1, the bf16 route for channel counts that are multiples of
// 16).
//
//   out[b] = demod[b] ⊙ conv3x3_SAME(x_mod[b], round_bf16(Σₙ a[b,n]·Wₙ))
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// gigagan_tpu/ops/pallas/adaptive_conv.py (called through `_fwd_call`), as
// adaptive_conv_fwd.cu does on CUDA cores for fp32 and other channel counts.
// Layouts as there: x_mod (b, h, w, ci) bf16; W (n, 3, 3, ci, co) fp32 or
// bf16; a (b, n) fp32; demod (b, co) fp32; out (b, h, w, co) bf16.
//
// What bounds it on an H100: 2·h·w·9·ci·co FLOPs per sample against the
// activations, bytes-bound at the generator's thin large maps (256², 16-32
// channels) and operation-bound at the wide ones.  Design: an implicit GEMM
// per sample on `wgmma` with fp32 accumulators, M = pixels, N = output
// channels, K = 9 taps × input channels.
//
// - A (pixels × channels) comes from x by TMA, read in place through a 4-D
//   map over (c, w, h, b) whose zero fill outside the map IS the SAME
//   padding.  A block tile is 16 image rows × 8 pixels (8 rows per consumer
//   warpgroup, 64 pixels = one wgmma M).  Per chunk of CK input channels the
//   producer warp loads three boxes of 18 rows × 8 pixels, shifted by
//   kx − 1 in x; tap (ky, kx) is box kx read from image row ky on, which is
//   a whole number of 8-row core groups, so each tap is a plain descriptor
//   offset and nothing is copied.  The boxes keep CK channels per pixel row
//   (32, 64 or 128 bytes) with the matching swizzle, so thin layers (16 or
//   32 channels) load no padding.
// - B (channels × output channels, K-major) is the mixed kernel.  The bank
//   mix stays on chip as in the Pallas kernel: the block's 256 consumer
//   threads mix its (ci split, co tile) slice of the n banks with a[b, :] in
//   fp32, round once to bf16 and store it straight into the swizzled layout
//   the descriptor reads.  The slice (9 taps × ci_split × N bf16, at most
//   72 KB) stays resident while the block walks its pixel tiles, so no
//   per-sample mixed weight reaches device memory and the mix is paid once
//   per block, not per tile.
// - Epilogue: demod applied in fp32 to the accumulator, then the cast; or,
//   when ci is split across blocks, fp32 partial sums that a second kernel
//   adds in a fixed split order (deterministic, no atomics), scales and
//   casts.
//
// The fixed shape table (`plan_for`, no tuning at run time):
// - CK = 64 channels per chunk if ci % 64 == 0, else 32, else 16;
// - N = 64 output channels per block if co % 64 == 0, else 32, else 16
//   (m64n64k16, m64n32k16 or m64n16k16);
// - ci_split: as many CK chunks as keep the resident B slice within 72 KB
//   (64 channels at N = 64, CK = 64), so the wide small maps (4²-32² at
//   ci = 256-512) split ci across 4-8 blocks and reduce, which also gives
//   those maps enough blocks for 132 SMs (the "small, wide maps" hazard);
// - the pixel tiles of one (sample, split, co tile) are cut into parts so
//   that about two blocks per SM exist: the thin large maps (256² × 16-32)
//   run ~256 blocks of 16 tiles, each streaming its x tiles through a ring
//   of TMA stages while the B slice, mixed once, stays put (the "thin,
//   large maps" hazard);
// - ring stages: as many as fit beside B in shared memory, 2 to 4.
//
// One block: two consumer warpgroups and one producer warp (288 threads);
// ptxas allocates 64-72 registers a thread and spills nothing, so no
// `setmaxnreg` is needed.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace tc;

constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kTW = 8;                    // pixels per tile row
constexpr int kTH = 16;                   // image rows per tile
constexpr int kBoxRows = kTW * (kTH + 2);  // 144 pixel rows per kx box
constexpr int kBBudget = 72 * 1024;
constexpr int kSmemMax = 227 * 1024;

struct Plan {
  int ck, nt, ci_split, splits, co_tiles, tiles_w, tiles, tpp, parts,
      stages, b_bytes, stage_bytes, smem;
};

inline Plan plan_for(int b, int h, int wd, int ci, int co, int sms) {
  Plan p;
  p.ck = ci % 64 == 0 ? 64 : ci % 32 == 0 ? 32 : 16;
  p.nt = co % 64 == 0 ? 64 : co % 32 == 0 ? 32 : 16;
  const int per_chunk = 9 * p.ck * p.nt * 2;
  const int chunks = kBBudget / per_chunk > 0 ? kBBudget / per_chunk : 1;
  p.ci_split = chunks * p.ck < ci ? chunks * p.ck : ci;
  p.splits = (ci + p.ci_split - 1) / p.ci_split;
  p.co_tiles = co / p.nt;
  p.tiles_w = (wd + kTW - 1) / kTW;
  p.tiles = ((h + kTH - 1) / kTH) * p.tiles_w;
  const long groups = (long)b * p.splits * p.co_tiles;
  long parts = (2L * sms + groups - 1) / groups;
  if (parts > p.tiles) parts = p.tiles;
  if (parts < 1) parts = 1;
  p.tpp = (int)((p.tiles + parts - 1) / parts);
  p.parts = (p.tiles + p.tpp - 1) / p.tpp;
  p.b_bytes = (p.ci_split / p.ck) * per_chunk;
  p.stage_bytes = 3 * kBoxRows * 2 * p.ck;
  int stages = (kSmemMax - 1024 - 256 - p.b_bytes) / p.stage_bytes;
  p.stages = stages > 4 ? 4 : stages;
  p.smem = 1024 + p.stages * p.stage_bytes + p.b_bytes + 16 * p.stages;
  return p;
}

template <typename WT>
__device__ __forceinline__ float ld(const WT* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename WT, int CK, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv_fwd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const WT* __restrict__ w, const float* __restrict__ a,
                   const float* __restrict__ demod,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ partial, int b, int h, int wd, int ci,
                   int co, int n, int ci_split, int splits, int co_tiles,
                   int parts, int tiles_w, int tiles, int tpp, int stages) {
  constexpr int RB = 2 * CK;             // bytes per pixel row of a chunk
  constexpr int kBox = kBoxRows * RB;    // one kx box
  constexpr int kStage = 3 * kBox;
  constexpr int kBTile = N * RB;         // one tap's mixed (N, CK) tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bbase = base + stages * kStage;

  // blockIdx.x = ((sample · splits + split) · co_tiles + co tile) · parts
  //              + part
  int rest = blockIdx.x;
  const int part = rest % parts;
  rest /= parts;
  const int ct = rest % co_tiles;
  rest /= co_tiles;
  const int sp = rest % splits;
  const int bi = rest / splits;
  const int t0 = part * tpp;
  const int t1 = min(tiles, t0 + tpp);
  const int c_begin = sp * ci_split;
  const int nch = (min(ci, c_begin + ci_split) - c_begin) / CK;
  const int co0 = ct * N;
  const uint32_t bars = bbase + nch * 9 * kBTile;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp: three shifted x boxes per (pixel tile, chunk)
    if (lane == 0) {
      int step = 0;
      for (int tile = t0; tile < t1; ++tile) {
        const int ty0 = (tile / tiles_w) * kTH;
        const int tx0 = (tile % tiles_w) * kTW;
        for (int j = 0; j < nch; ++j, ++step) {
          const int s = step % stages;
          if (step >= stages) mbar_wait(empty(s), ((step / stages) - 1) & 1);
          mbar_arrive_tx(full(s), kStage);
          const uint32_t st = base + s * kStage;
          for (int kx = 0; kx < 3; ++kx)
            tma_load_4d(st + kx * kBox, &xmap, full(s), c_begin + j * CK,
                        tx0 + kx - 1, ty0 - 1, bi);
        }
      }
    }
  } else {
    // ---- the resident B slice: 9 taps per chunk, mixed in fp32, rounded
    // once to bf16, stored swizzled; o runs fastest so the bank reads of a
    // warp are coalesced
    const float* a_b = a + (size_t)bi * n;
    const size_t bank = (size_t)9 * ci * co;
    const int units = nch * 9 * N * (CK / 8);
#pragma unroll 2
    for (int u = threadIdx.x; u < units; u += kConsumers) {
      const int o = u % N;
      int r = u / N;
      const int cq = r % (CK / 8);
      r /= CK / 8;
      const int tap = r % 9;
      const int j = r / 9;
      const int c = c_begin + j * CK + cq * 8;
      const WT* src = w + ((size_t)tap * ci + c) * co + co0 + o;
      float m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = 0.f;
      for (int k = 0; k < n; ++k) {
        const float ak = a_b[k];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          m[e] = fmaf(ak, ld(src + k * bank + (size_t)e * co), m[e]);
      }
      uint4 v;
      v.x = pack_bf16(m[0], m[1]);
      v.y = pack_bf16(m[2], m[3]);
      v.z = pack_bf16(m[4], m[5]);
      v.w = pack_bf16(m[6], m[7]);
      const uint32_t off =
          swizzle<RB>((uint32_t)((j * 9 + tap) * kBTile + o * RB + cq * 16));
      *reinterpret_cast<uint4*>(smem + stages * kStage + off) = v;
    }
    fence_proxy_async();
    consumer_sync(kConsumers);

    const int wg = warp / 4;
    const int py_lo = 8 * wg + 2 * (warp % 4);  // rows py_lo (i = 0), +1
    const int px = lane / 4;
    const int cq2 = 2 * (lane % 4);
    int step = 0;
    for (int tile = t0; tile < t1; ++tile) {
      float acc[N / 2];
#pragma unroll
      for (int r = 0; r < N / 2; ++r) acc[r] = 0.f;
      for (int j = 0; j < nch; ++j, ++step) {
        const int s = step % stages;
        mbar_wait(full(s), (step / stages) & 1);
        const uint32_t st = base + s * kStage;
        const uint32_t bt = bbase + j * 9 * kBTile;
        wgmma_fence();
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const uint32_t at = st + kx * kBox + (8 * wg + ky) * kTW * RB;
            const uint32_t btap = bt + (ky * 3 + kx) * kBTile;
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk)
              mma_ss_n<N>(acc, desc_rows<RB>(at + kk * 32),
                            desc_rows<RB>(btap + kk * 32));
          }
        wgmma_commit();
        wgmma_wait();
        fence_acc(acc);
        mbar_arrive(empty(s));
      }

      const int ty0 = (tile / tiles_w) * kTH;
      const int gx = (tile % tiles_w) * kTW + px;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gy = ty0 + py_lo + i;
        if (gy >= h || gx >= wd) continue;
        const size_t pix = ((size_t)bi * h + gy) * wd + gx;
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int o = co0 + 8 * jj + cq2;
          const float v0 = acc[4 * jj + 2 * i], v1 = acc[4 * jj + 2 * i + 1];
          if (splits > 1) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)sp * b * h * wd + pix) * co + o) =
                make_float2(v0, v1);
          } else {
            const float2 dm = *reinterpret_cast<const float2*>(
                demod + (size_t)bi * co + o);
            *reinterpret_cast<__nv_bfloat162*>(out + pix * co + o) =
                __floats2bfloat162_rn(v0 * dm.x, v1 * dm.y);
          }
        }
      }
    }
  }
}

// out = bf16(demod ⊙ Σ_split partial[split]), partials added in split order
__global__ void __launch_bounds__(256)
conv_reduce_kernel(const float* __restrict__ partial,
                   const float* __restrict__ demod,
                   __nv_bfloat16* __restrict__ out, int splits, int hw, int co,
                   size_t total) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  const int o = (int)(idx % co);
  const size_t bi = idx / ((size_t)hw * co);
  out[idx] = __float2bfloat16(sum * demod[bi * co + o]);
}

template <typename WT, int CK, int N>
cudaError_t launch(const Plan& p, const void* x, const void* w,
                   const float* a, const float* demod, void* out,
                   float* partial, int b, int h, int wd, int ci, int co, int n,
                   cudaStream_t stream) {
  CUtensorMap xmap;
  cudaError_t err = make_map_nhwc(&xmap, x, b, h, wd, ci, CK, kTW, kTH + 2);
  if (err != cudaSuccess) return err;
  auto kernel = conv_fwd_tc_kernel<WT, CK, N>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)b * p.splits * p.co_tiles * p.parts;
  kernel<<<blocks, kThreads, p.smem, stream>>>(
      xmap, static_cast<const WT*>(w), a, demod,
      static_cast<__nv_bfloat16*>(out), partial, b, h, wd, ci, co, n,
      p.ci_split, p.splits, p.co_tiles, p.parts, p.tiles_w, p.tiles, p.tpp,
      p.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t total = (size_t)b * h * wd * co;
  conv_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, demod, static_cast<__nv_bfloat16*>(out), p.splits, h * wd, co,
      total);
  return cudaGetLastError();
}

template <typename WT, int CK>
cudaError_t by_n(const Plan& p, const void* x, const void* w, const float* a,
                 const float* demod, void* out, float* partial, int b, int h,
                 int wd, int ci, int co, int n, cudaStream_t s) {
  if (p.nt == 64)
    return launch<WT, CK, 64>(p, x, w, a, demod, out, partial, b, h, wd, ci,
                              co, n, s);
  if (p.nt == 32)
    return launch<WT, CK, 32>(p, x, w, a, demod, out, partial, b, h, wd, ci,
                              co, n, s);
  return launch<WT, CK, 16>(p, x, w, a, demod, out, partial, b, h, wd, ci, co,
                            n, s);
}

template <typename WT>
cudaError_t by_ck(const Plan& p, const void* x, const void* w, const float* a,
                  const float* demod, void* out, float* partial, int b, int h,
                  int wd, int ci, int co, int n, cudaStream_t s) {
  if (p.ck == 64)
    return by_n<WT, 64>(p, x, w, a, demod, out, partial, b, h, wd, ci, co, n,
                        s);
  if (p.ck == 32)
    return by_n<WT, 32>(p, x, w, a, demod, out, partial, b, h, wd, ci, co, n,
                        s);
  return by_n<WT, 16>(p, x, w, a, demod, out, partial, b, h, wd, ci, co, n,
                      s);
}

inline bool plan_device(int b, int h, int wd, int ci, int co, int device,
                        Plan* p) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return false;
  *p = plan_for(b, h, wd, ci, co, sms);
  return true;
}

}  // namespace

// The number of ci splits the call will use; the call needs an fp32
// workspace of splits·b·h·w·co floats when it is above 1.  Returns <= 0 on
// a CUDA error.
extern "C" int gigagan_adaptive_conv_fwd_tc_splits(int b, int h, int wd,
                                                   int ci, int co,
                                                   int device) {
  Plan p;
  if (ci <= 0 || co <= 0 || !plan_device(b, h, wd, ci, co, device, &p))
    return 0;
  return p.splits;
}

// bf16 x and out; weights fp32 (w_dtype 0) or bf16 (1); ci and co multiples
// of 16; x 16-byte aligned (read by TMA).  `partial` may be null when the call
// uses one split.  Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_fwd_tc(const void* x, const void* w,
                                            const void* a, const void* demod,
                                            void* out, void* partial, int b,
                                            int h, int wd, int ci, int co,
                                            int n, int w_dtype, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 || n <= 0 ||
      ci % 16 != 0 || co % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  Plan p;
  if (!plan_device(b, h, wd, ci, co, device, &p)) return cudaErrorInvalidValue;
  if (p.stages < 2 || (p.splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(demod);
  float* pf = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return by_ck<float>(p, x, w, af, df, out, pf, b, h, wd, ci, co, n, s);
  if (w_dtype == 1)
    return by_ck<__nv_bfloat16>(p, x, w, af, df, out, pf, b, h, wd, ci, co,
                                n, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
