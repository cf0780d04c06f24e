// Weight and bank-coefficient gradient of the sample-adaptive 3x3 conv on
// Hopper's tensor cores (kernel K2, the bf16 route for channel counts that
// are multiples of 16):
//
//   C[b, ky, kx, i, o] = Σ_{r,c} x_pad[b, r+ky, c+kx, i] · g[b, r, c, o]
//   dW[n] = Σ_b a[b,n] · C[b]          da[b,n] = ⟨Wₙ, C[b]⟩
//
// Replaces the Pallas TPU kernel `_bwd_w_kernel` in
// gigagan_tpu/ops/pallas/adaptive_conv.py (called through `_bwd_w_pallas`),
// as adaptive_conv_bwd_w.cu does on CUDA cores for fp32 and other channel
// counts.  Layouts as there: x (b, h, w, ci) and g (b, h, w, co) bf16;
// W (n, 3, 3, ci, co) fp32 or bf16; a (b, n) fp32; dW (n, 3, 3, ci, co)
// and da (b, n) fp32.  At most kBanks banks a launch (the wrapper groups
// more).
//
// What bounds it on an H100: bytes.  The generator's 15 convs need 43 GFLOP
// (44 µs of tensor-core time) but move x, g, W and dW (≈ 0.4 GB, 120 µs).
// At the wide small maps (4², 8² × 512 channels) W and dW are nearly all
// of it; at the thin large maps (256² × 16) x and g are.  So C must not
// reach device memory, and the pixel reduction must fill 132 SMs on a
// 9·16·16 output.
//
// Design: an implicit GEMM per sample on `wgmma` with fp32 accumulators,
// M = (tap, input channel), N = output channels, K = pixels.
//
// - Both operands come by TMA through 4-D NHWC maps, with channels along a
//   shared-memory row and pixels down the rows, so both are MN-major (the
//   transpose bits).  A K chunk is one box of 64 pixels (bw × bh, bw the
//   map width rounded up to a power of two in [8, 64]); g's box is zero
//   filled past the map's ragged edge, and tap (ky, kx)'s box of x is the
//   same pixels shifted by (ky − 1, kx − 1), whose zero fill outside the
//   map is the SAME padding.
// - M = 64 rows of one warpgroup: 64 channels of one tap when ci is a
//   multiple of 64, else the CK = 16 or 32 channels of 64 / CK taps, each
//   tap its own box, the boxes one stride apart: the MN-major descriptor
//   of 32- or 64-byte rows spans them with LBO = that stride
//   (`desc_rows`).  So the thin layers load no padding channels.  9
//   taps make 3 (CK = 16) or 5 (CK = 32) such M tiles; the last one starts
//   at tap 9 − 64 / CK and drops the rows of taps an earlier tile has.
// - C never reaches device memory.  A block sweeps the samples innermost,
//   as the Pallas grid does: after a sample's pixels it folds its
//   accumulator into resident fp32 dW registers, dW += a[b,n]·C_b (C
//   rounded nowhere, `a` applied in fp32), and reduces ⟨Wₙ, C_b⟩ over its
//   tile (Wₙ staged once per block in shared memory, in the accumulator's
//   register order) into one da partial per warp.
// - Blocks: (ci tile, M tile, co tile) units × pixel splits.  The wide
//   small maps have hundreds of units and one split; the thin large maps
//   have 3-9 units, so their pixels are split until about two blocks per
//   SM exist, and every block writes its n·9·ci_t·co_t dW partial; a
//   second kernel adds the splits in a fixed order.  da's partials (per
//   block and warp) are added in a fixed order by a third.  No float
//   atomics: the result is deterministic.
//
// One block: one consumer warpgroup and one producer warp (160 threads),
// a ring of 4 stages of (64 / CK x boxes + one g box) = 8 KB + 128·N bytes;
// ptxas gives 59-154 registers and no spills.  (Deeper rings for the thin
// layers and `a` loaded ahead of each sample's sweep measured no faster on
// an H100.)

#include "hopper_tc.cuh"

namespace {

using namespace tc;

constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
constexpr int kPix = 64;  // pixels per K chunk (one box)
constexpr int kStages = 4;
constexpr int kBanks = 2;
constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;  // devices whose host-side facts are cached

inline bool cached(int device) { return device >= 0 && device < kMaxDevices; }

struct Plan {
  int ck, tpm, mtiles, ci_tiles, nt, co_tiles, units, bw, bh, tiles_w,
      chunks, cps, splits, stage_bytes, smem;
};

inline Plan plan_for(int h, int wd, int ci, int co, int sms) {
  Plan p;
  p.ck = ci % 64 == 0 ? 64 : ci % 32 == 0 ? 32 : 16;
  p.tpm = 64 / p.ck;  // taps per M tile
  p.mtiles = (9 + p.tpm - 1) / p.tpm;
  p.ci_tiles = ci / p.ck;
  p.nt = co % 64 == 0 ? 64 : co % 32 == 0 ? 32 : 16;
  p.co_tiles = co / p.nt;
  p.units = p.ci_tiles * p.mtiles * p.co_tiles;
  p.bw = wd > 32 ? 64 : wd > 16 ? 32 : wd > 8 ? 16 : 8;
  p.bh = kPix / p.bw;
  p.tiles_w = (wd + p.bw - 1) / p.bw;
  p.chunks = ((h + p.bh - 1) / p.bh) * p.tiles_w;
  long splits = (2L * sms + p.units - 1) / p.units;
  if (splits > p.chunks) splits = p.chunks;
  if (splits < 1) splits = 1;
  p.cps = (int)((p.chunks + splits - 1) / splits);
  p.splits = (p.chunks + p.cps - 1) / p.cps;
  p.stage_bytes = kPix * 2 * p.ck * p.tpm + kPix * 2 * p.nt;
  // ring, W's tile in register order (kBanks · N/2 · 128 floats), barriers
  p.smem = 1024 + kStages * p.stage_bytes + kBanks * (p.nt / 2) * 128 * 4 +
           16 * kStages;
  return p;
}

template <int CK, int N>
__global__ void __launch_bounds__(kThreads, 2)
corr_tc_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap gmap,
               const void* __restrict__ w, int w_bf16,
               const float* __restrict__ a, float* __restrict__ dw_out,
               float* __restrict__ da_part, int b, int ci, int co, int n,
               int mtiles, int ci_tiles, int units, int tiles_w, int bw,
               int bh, int chunks, int cps) {
  constexpr int TPM = 64 / CK;
  constexpr int RB = 2 * CK;       // bytes per pixel row of an x box
  constexpr int GB = 2 * N;        // bytes per pixel row of the g box
  constexpr int XBOX = kPix * RB;  // one tap's box
  constexpr int STAGE = TPM * XBOX + kPix * GB;
  constexpr int R = N / 2;  // accumulator registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* wsm = reinterpret_cast<float*>(smem + kStages * STAGE);
  const uint32_t bars = base + kStages * STAGE + kBanks * R * 128 * 4;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  // blockIdx.x = split · units + ((co tile · ci_tiles + ci tile) · mtiles
  //              + M tile): the units of one split read the same pixels
  const int split = blockIdx.x / units;
  int rest = blockIdx.x % units;
  const int mt = rest % mtiles;
  rest /= mtiles;
  const int cit = rest % ci_tiles;
  const int ct = rest / ci_tiles;
  const int ci0 = cit * CK, co0 = ct * N;
  const int tap_lo = mt * TPM;           // first tap this tile owns
  const int tap0 = min(tap_lo, 9 - TPM);  // first tap its rows hold
  const int c_begin = split * cps;
  const int c_end = min(chunks, c_begin + cps);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp: per (sample, chunk) TPM shifted x boxes and g's
    if (lane == 0) {
      int step = 0;
      for (int bi = 0; bi < b; ++bi) {
        for (int c = c_begin; c < c_end; ++c, ++step) {
          const int s = step % kStages;
          if (step >= kStages)
            mbar_wait(empty(s), ((step / kStages) - 1) & 1);
          mbar_arrive_tx(full(s), STAGE);
          const int ty0 = (c / tiles_w) * bh;
          const int tx0 = (c % tiles_w) * bw;
          const uint32_t st = base + s * STAGE;
          for (int j = 0; j < TPM; ++j) {
            const int tap = tap0 + j;
            tma_load_4d(st + j * XBOX, &xmap, full(s), ci0,
                        tx0 + tap % 3 - 1, ty0 + tap / 3 - 1, bi);
          }
          tma_load_4d(st + TPM * XBOX, &gmap, full(s), co0, tx0, ty0, bi);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup.  Thread t holds rows m = 16·warp + lane/4
  // (+8) and columns 8j + 2(lane % 4) (+1) of the m64nN accumulator; row m
  // is channel ci0 + m % CK of tap tap0 + m / CK.
  const int t = threadIdx.x;
  auto row_of = [&](int r) {
    return 16 * warp + lane / 4 + 8 * ((r / 2) % 2);
  };
  auto col_of = [&](int r) { return 8 * (r / 4) + 2 * (lane % 4) + r % 2; };
  const size_t bank = (size_t)9 * ci * co;
  // Wₙ's tile in this thread's register order (0 on rows another tile owns
  // and on banks past n), read back only by this thread
#pragma unroll
  for (int k = 0; k < kBanks; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = row_of(r);
      const int tap = tap0 + m / CK;
      float v = 0.f;
      if (k < n && tap >= tap_lo) {
        const size_t e = k * bank + ((size_t)tap * ci + ci0 + m % CK) * co +
                         co0 + col_of(r);
        v = w_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(w)[e])
                   : static_cast<const float*>(w)[e];
      }
      wsm[(k * R + r) * 128 + t] = v;
    }

  float acc[R], dw[kBanks][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kBanks; ++k) dw[k][r] = 0.f;
  }
  int step = 0;
  for (int bi = 0; bi < b; ++bi) {
    for (int c = c_begin; c < c_end; ++c, ++step) {
      const int s = step % kStages;
      mbar_wait(full(s), (step / kStages) & 1);
      const uint32_t st = base + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPix / 16; ++kk)
        mma_ss_n<N, 1, 1>(acc, desc_rows<RB>(st + kk * 16 * RB, XBOX),
                          desc_rows<GB>(st + TPM * XBOX + kk * 16 * GB,
                                        kPix * GB));
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
      mbar_arrive(empty(s));
    }
    // fold C_b: dW += a[b, n]·C_b in fp32, and this warp's ⟨Wₙ, C_b⟩
#pragma unroll
    for (int k = 0; k < kBanks; ++k) {
      if (k >= n) continue;
      const float ak = a[bi * n + k];
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dw[k][r] = fmaf(ak, acc[r], dw[k][r]);
        sum = fmaf(wsm[(k * R + r) * 128 + t], acc[r], sum);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0)
        da_part[(((size_t)blockIdx.x * 4 + warp) * b + bi) * n + k] = sum;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
  }

  // this split's dW tile (the whole of dW when there is one split)
  float* out = dw_out + (size_t)split * n * bank;
#pragma unroll
  for (int k = 0; k < kBanks; ++k) {
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const int m = row_of(r);
      const int tap = tap0 + m / CK;
      if (k >= n || tap < tap_lo) continue;
      const size_t e = k * bank + ((size_t)tap * ci + ci0 + m % CK) * co +
                       co0 + col_of(r);
      *reinterpret_cast<float2*>(out + e) =
          make_float2(dw[k][r], dw[k][r + 1]);
    }
  }
}

// dW[e] = Σ_split partial[split][e], in split order
__global__ void __launch_bounds__(kReduceThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                 int splits, size_t elems) {
  const size_t e = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(size_t)i * elems + e];
  dw[e] = s;
}

// da[j] = Σ over the (block, warp) partials of j, one block per (b, n);
// a fixed tree, so a fixed order
__global__ void __launch_bounds__(kReduceThreads)
da_reduce_kernel(const float* __restrict__ da_part, float* __restrict__ da,
                 int bn, int parts) {
  __shared__ float red[kReduceThreads / 32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int p = threadIdx.x; p < parts; p += kReduceThreads)
    s += da_part[(size_t)p * bn + j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kReduceThreads / 32; ++i) total += red[i];
    da[j] = total;
  }
}

template <int CK, int N>
cudaError_t launch(const Plan& p, const void* x, const void* g,
                   const void* w, int w_bf16, const float* a, float* dw,
                   float* da, float* partial, float* da_part, int b, int h,
                   int wd, int ci, int co, int n, int device,
                   cudaStream_t stream) {
  CUtensorMap xmap, gmap;
  cudaError_t err = make_map_nhwc(&xmap, x, b, h, wd, ci, CK, p.bw, p.bh);
  if (err != cudaSuccess) return err;
  err = make_map_nhwc(&gmap, g, b, h, wd, co, N, p.bw, p.bh);
  if (err != cudaSuccess) return err;
  auto kernel = corr_tc_kernel<CK, N>;
  // the shared-memory limit, raised per device only when a launch needs more
  // than it was set to (a race sets it twice, harmlessly)
  static int smem_set[kMaxDevices] = {};
  if (!cached(device) || smem_set[device] < p.smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return err;
    if (cached(device)) smem_set[device] = p.smem;
  }
  const unsigned blocks = (unsigned)p.units * p.splits;
  kernel<<<blocks, kThreads, p.smem, stream>>>(
      xmap, gmap, w, w_bf16, a, p.splits > 1 ? partial : dw, da_part, b, ci,
      co, n, p.mtiles, p.ci_tiles, p.units, p.tiles_w, p.bw, p.bh, p.chunks,
      p.cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.splits > 1) {
    const size_t elems = (size_t)n * 9 * ci * co;
    dw_reduce_kernel<<<(unsigned)((elems + kReduceThreads - 1) /
                                  kReduceThreads),
                       kReduceThreads, 0, stream>>>(partial, dw, p.splits,
                                                    elems);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  da_reduce_kernel<<<b * n, kReduceThreads, 0, stream>>>(da_part, da, b * n,
                                                         (int)blocks * 4);
  return cudaGetLastError();
}

template <int CK>
cudaError_t by_n(const Plan& p, const void* x, const void* g, const void* w,
                 int w_bf16, const float* a, float* dw, float* da,
                 float* partial, float* da_part, int b, int h, int wd, int ci,
                 int co, int n, int device, cudaStream_t s) {
  if (p.nt == 64)
    return launch<CK, 64>(p, x, g, w, w_bf16, a, dw, da, partial, da_part, b,
                          h, wd, ci, co, n, device, s);
  if (p.nt == 32)
    return launch<CK, 32>(p, x, g, w, w_bf16, a, dw, da, partial, da_part, b,
                          h, wd, ci, co, n, device, s);
  return launch<CK, 16>(p, x, g, w, w_bf16, a, dw, da, partial, da_part, b, h,
                        wd, ci, co, n, device, s);
}

// the device's SM count, read once per device
inline bool plan_device(int h, int wd, int ci, int co, int device, Plan* p) {
  static int sms_of[kMaxDevices] = {};
  int sms = cached(device) ? sms_of[device] : 0;
  if (sms <= 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        sms <= 0)
      return false;
    if (cached(device)) sms_of[device] = sms;
  }
  *p = plan_for(h, wd, ci, co, sms);
  return true;
}

inline bool shape_ok(int b, int h, int wd, int ci, int co, int n) {
  return b > 0 && h > 0 && wd > 0 && ci > 0 && co > 0 && n > 0 &&
         n <= kBanks && ci % 16 == 0 && co % 16 == 0;
}

}  // namespace

// Workspace the call needs, in floats: the dW partials of the pixel splits
// (0 when there is one split) and the per-(block, warp) partials of da.
// Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_bwd_w_tc_workspace(
    int b, int h, int wd, int ci, int co, int n, int device,
    long* partial_floats, long* da_partial_floats) {
  if (!shape_ok(b, h, wd, ci, co, n)) return cudaErrorInvalidValue;
  Plan p;
  if (!plan_device(h, wd, ci, co, device, &p)) return cudaErrorInvalidDevice;
  *partial_floats = p.splits > 1 ? (long)p.splits * n * 9 * ci * co : 0;
  *da_partial_floats = (long)p.units * p.splits * 4 * b * n;
  return cudaSuccess;
}

// bf16 x and g (16-byte aligned, read by TMA); weights fp32 (w_dtype 0) or
// bf16 (1); ci and co multiples of 16; n <= 2.  `partial` may be null when
// the workspace query gave 0 floats.  Returns a cudaError_t.
extern "C" int gigagan_adaptive_conv_bwd_w_tc(
    const void* x, const void* g, const void* w, const void* a, void* dw,
    void* da, void* partial, void* da_partial, int b, int h, int wd, int ci,
    int co, int n, int w_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(b, h, wd, ci, co, n) || (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  Plan p;
  if (!plan_device(h, wd, ci, co, device, &p)) return cudaErrorInvalidDevice;
  if (p.splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  float* dwf = static_cast<float*>(dw);
  float* daf = static_cast<float*>(da);
  float* pf = static_cast<float*>(partial);
  float* dpf = static_cast<float*>(da_partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ck == 64)
    return by_n<64>(p, x, g, w, w_dtype, af, dwf, daf, pf, dpf, b, h, wd, ci,
                    co, n, device, s);
  if (p.ck == 32)
    return by_n<32>(p, x, g, w, w_dtype, af, dwf, daf, pf, dpf, b, h, wd, ci,
                    co, n, device, s);
  return by_n<16>(p, x, g, w, w_dtype, af, dwf, daf, pf, dpf, b, h, wd, ci,
                  co, n, device, s);
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
