// Pieces shared by the tensor-core K7a and K7b
// (flash_attention_hv_jvp_tc.cu, flash_attention_hv_bwd_tc.cu): the block
// shape, the shared-memory layout and the producer warp, on the building
// blocks of hopper_tc.cuh.
//
// A block is two consumer warpgroups of 64 rows each (128 resident rows)
// and one producer warp, 288 threads, as K5-_tc's: the register file's
// quarters take three of the nine warps each, so ptxas allocates 168
// registers a thread.  Operands are K6a's split-heads (b·h, n, 64) bf16
// tensors, read through 3-D TMA maps (make_map with H·d = 64, b = b·h) in
// (64 × 64) atoms with the 128-byte swizzle.  The producer warp loads the
// resident 128-row tiles once, then streams 64-row tiles of the other side
// through a ring of stages on mbarriers, writing each stage's per-row
// values (biases, lse, statistics) before it arrives.  The consumers take
// each streamed tile in two 32-column pieces (m64n32k16 products), so a
// piece's fp32 maps take 16 registers each.

#pragma once

#include "hopper_tc.cuh"

namespace hv {

using namespace tc;

constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kBlockRows = 128;             // resident rows per block
constexpr int kCols = 64;                   // rows of a streamed tile
constexpr int kD = 64;                      // the head dim these take
constexpr int kTile = kAtomBytes;           // 64 rows × 64 bf16
constexpr int kRes = 2 * kAtomBytes;        // 128 rows
constexpr int KP = 32;                      // columns of a piece

// NRES resident 128-row tiles, STAGES ring stages of NSTR streamed tiles
// and NVEC rows of 64 floats each, then the barriers: one for the resident
// tiles, then `full` and `empty` per stage
template <int NRES, int NSTR, int NVEC, int STAGES>
struct Layout {
  static constexpr int kStages = STAGES;
  static constexpr int kRing = NRES * kRes;
  static constexpr int kStage = NSTR * kTile;
  static constexpr int kVec = kRing + STAGES * kStage;
  static constexpr int kVecStage = NVEC * kCols;  // floats per stage
  static constexpr int kBars = kVec + STAGES * kVecStage * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * STAGES) + 1024;
};

struct Bars {
  uint32_t res;
  int stages;
  __device__ uint32_t full(int s) const { return res + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return res + 8 * (1 + stages + s);
  }
};

__device__ __forceinline__ Bars init_bars(uint32_t at, int stages) {
  const Bars b{at, stages};
  if (threadIdx.x == 0) {
    mbar_init(b.res, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(b.full(s), 32);
      mbar_init(b.empty(s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return b;
}

// The producer warp: `nres` resident 128-row tiles of the maps `res` (rows
// r0 .. r0+127 of sample bi) at base + m·kRes, then `steps` ring steps,
// each the `nstr` 64-row tiles of the maps `str` at rows 64·(t % ntiles),
// with `fill(s, t % ntiles)` writing the stage's per-row values first.
template <typename Fill>
__device__ __forceinline__ void produce(const Bars& bars, uint32_t base,
                                        const CUtensorMap* const* res,
                                        int nres, const CUtensorMap* const* str,
                                        int nstr, int r0, int bi, int steps,
                                        int ntiles, int ring, int stage,
                                        Fill fill) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_tx(bars.res, nres * kRes);
    for (int m = 0; m < nres; ++m)
      for (int wg = 0; wg < 2; ++wg)
        tma_load(base + m * kRes + wg * kAtomBytes, res[m], bars.res, 0,
                 r0 + 64 * wg, bi);
  }
  for (int t = 0; t < steps; ++t) {
    const int s = t % bars.stages;
    if (t >= bars.stages) mbar_wait(bars.empty(s), ((t / bars.stages) - 1) & 1);
    fill(s, t % ntiles);
    if (lane == 0) {
      mbar_arrive_tx(bars.full(s), nstr * kTile);
      const uint32_t st = base + ring + s * stage;
      for (int m = 0; m < nstr; ++m)
        tma_load(st + m * kTile, str[m], bars.full(s), 0,
                 (t % ntiles) * kCols, bi);
    } else {
      mbar_arrive(bars.full(s));
    }
  }
}

// A key tile's bias row in the log2 domain (−inf past nk: no weight) and
// its tangent row (0 past nk), for the query-major kernels
__device__ __forceinline__ void stage_key_rows(float* v, const float* bias,
                                               const float* tbias, int k0,
                                               int nk) {
  for (int c = threadIdx.x % 32; c < kCols; c += 32) {
    const int key = k0 + c;
    const bool ok = key < nk;
    v[c] = ok ? to_log2(bias[key]) : -INFINITY;
    v[kCols + c] = ok ? tbias[key] : 0.f;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the (64 rows, 64 columns) accumulator of a warpgroup to rows of a
// (n, 64) output in global memory: bf16 or fp32
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[32], int i,
                                          float scale) {
  const int cq2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq2) =
        __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                              acc[4 * j + 2 * i + 1] * scale);
}

__device__ __forceinline__ void store_row(float* dst, const float (&acc)[32],
                                          int i, float scale) {
  const int cq2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float2*>(dst + 8 * j + cq2) =
        make_float2(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
}

}  // namespace hv
