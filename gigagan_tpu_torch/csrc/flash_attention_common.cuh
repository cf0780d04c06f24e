// Pieces shared by the fused-heads attention backward (K4,
// flash_attention_fused_bwd.cu), its adjoint (K5,
// flash_attention_so_bwd2.cu) and the split-heads kernels K6a/K6b
// (flash_attention_fwd.cu, flash_attention_bwd.cu) and K7a/K7b
// (flash_attention_hv_jvp.cu, flash_attention_hv_bwd.cu).
//
// K4 and K5 keep the layout of the forward K3: operands stay in the
// network's (b, n, H·d) layout and are read in place with a row stride of
// H·d.  The split-heads kernels read (b·h, n, d) operands, row stride d.
// A block is 128 threads over a 64 × 64 tile of (rows, columns) of the
// attention map: thread (tx = tid % 16, ty = tid / 16) owns rows
// ty·8 .. ty·8+7 and columns tx + 16·j (j < 4), and output dims
// tx + 16·c (c < DC) of its rows.  The 16 threads of a row are one
// half-warp, so row sums are shuffles and a (64, 64) tile that a thread
// group writes and reads back by rows needs only a warp barrier.  K7a/K7b
// stage more operands per tile and, for d > 64, take CPT = 2 columns per
// thread (a 64 × 32 tile) so that their shared memory fits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace flash {

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

// v rounded to the operand dtype, as the TPU kernels round matmul operands
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kThreads = 128;
constexpr int kTile = 64;  // rows and columns of a block's tile
constexpr int kRpt = 8;    // rows per thread
constexpr int kCpt = 4;    // columns per thread
constexpr int kLanes = 16; // threads sharing a row (one half-warp)

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// padded row stride of a staged (64, d) tile: float4-aligned, and 4 banks
// apart so a quarter-warp's float4 reads of 8 consecutive rows hit
// distinct banks
__host__ __device__ inline int tile_stride(int d) { return round4(d) + 4; }

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

// Store acc[i][c] (rows ty·8+i, dims tx+16c of a tile whose first row dst
// points at) with row stride d; rows past `valid` are skipped.
template <typename T, int DC>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kRpt][DC],
                                           int valid, int d) {
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = ty * kRpt + i;
    if (row >= valid) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dd = tx + kLanes * c;
      if (dd < d) dst[(size_t)row * d + dd] = from_f32<T>(acc[i][c]);
    }
  }
}

// Stage rows [0, rows) of a (n, H·d) operand (row 0 and the head offset
// already applied to src) as fp32 with row stride ds; rows past `valid`
// and columns past d are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int valid, size_t hd, int d,
                                          int ds, int rows = kTile) {
  for (int idx = threadIdx.x; idx < rows * ds; idx += kThreads) {
    const int r = idx / ds;
    const int c = idx % ds;
    dst[idx] = (r < valid && c < d) ? to_f32(src[(size_t)r * hd + c]) : 0.f;
  }
}

// acc[i][j] += A[row ty·8+i] · B[row tx+16j] over the d (padded) columns
template <int CPT>
__device__ __forceinline__ void tile_dot(float (&acc)[kRpt][CPT],
                                         const float* A, const float* B,
                                         int ds, int d4) {
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  for (int c4 = 0; c4 < d4; ++c4) {
    float4 bv[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      bv[j] = reinterpret_cast<const float4*>(B + (tx + kLanes * j) * ds)[c4];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float4 av =
          reinterpret_cast<const float4*>(A + (ty * kRpt + i) * ds)[c4];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][c] += Σ_j M[row ty·8+i][j] · V[j][tx+16c]: M a (64, 16·CPT) tile
// whose rows this thread's half-warp wrote, V a staged (16·CPT, d) tile
template <int DC, int CPT = kCpt>
__device__ __forceinline__ void tile_mm(float (&acc)[kRpt][DC],
                                        const float* M, const float* V,
                                        int ds, int d) {
  constexpr int kCols = kLanes * CPT;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  for (int j4 = 0; j4 < kCols / 4; ++j4) {
    float vv[4][DC];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dd = tx + kLanes * c;
        vv[jj][c] = dd < d ? V[(j4 * 4 + jj) * ds + dd] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float4 mv =
          reinterpret_cast<const float4*>(M + (ty * kRpt + i) * kCols)[j4];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        acc[i][c] = fmaf(mv.x, vv[0][c], acc[i][c]);
        acc[i][c] = fmaf(mv.y, vv[1][c], acc[i][c]);
        acc[i][c] = fmaf(mv.z, vv[2][c], acc[i][c]);
        acc[i][c] = fmaf(mv.w, vv[3][c], acc[i][c]);
      }
    }
  }
}

// Sum over the block's 8 row groups of per-thread partials of the null
// token's gradients (pk, pv over dims tx+16c; pb per row group, lane 0),
// written to part[slot][0 .. 2d] = (Σ pk | Σ pv | Σ pb).  `red` holds
// 8·(2d+1) floats; the block must be past its last use of it.
template <int DC>
__device__ __forceinline__ void write_null_partial(
    const float (&pk)[DC], const float (&pv)[DC], float pb, float* red,
    float* part, int d) {
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int w = 2 * d + 1;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int dd = tx + kLanes * c;
    if (dd < d) {
      red[ty * w + dd] = pk[c];
      red[ty * w + d + dd] = pv[c];
    }
  }
  if (tx == 0) red[ty * w + 2 * d] = pb;
  __syncthreads();
  for (int idx = threadIdx.x; idx < w; idx += kThreads) {
    float s = 0.f;
    for (int g = 0; g < kThreads / kLanes; ++g) s += red[g * w + idx];
    part[idx] = s;
  }
}

// null gradients: Σ over the (sample, query tile) partials in slot order,
// one block per head
__global__ void __launch_bounds__(kThreads)
null_reduce_kernel(const float* __restrict__ part, float* __restrict__ gk,
                   float* __restrict__ gv, float* __restrict__ gb, int slots,
                   int heads, int d) {
  const int hh = blockIdx.x;
  const int w = 2 * d + 1;
  for (int idx = threadIdx.x; idx < w; idx += kThreads) {
    float s = 0.f;
    for (int r = 0; r < slots; ++r) s += part[((size_t)r * heads + hh) * w + idx];
    if (idx < d) {
      gk[hh * d + idx] = s;
    } else if (idx < 2 * d) {
      gv[hh * d + idx - d] = s;
    } else {
      gb[hh] = s;
    }
  }
}

}  // namespace flash
