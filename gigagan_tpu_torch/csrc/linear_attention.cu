// The upsampler's linear attention (LinearAttention2D) for the calls that
// need no gradient (ops/kernels/linear_attention.py: the sampler's G
// forward, the d_step's fakes).  Per (sample b, head h), with q, k, v
// (n, d) slices of the fused-heads layout (b, n, H·d):
//
//   context = softmax_n(k)ᵀ · v                       (d × d)
//   out     = (softmax_d(q) · scale) · context        (n × d)
//
// No Pallas kernel precedes it: the JAX package leaves the layer to XLA
// (gigagan_tpu/ops/attention.py:211 `linear_attend_fused`), and the port's
// plain form (two fp32 softmaxes and two einsums) stays on every call that
// autograd differentiates.
//
// What bounds it on an H100: bytes.  A call does 4·n·d² operations per
// head and must read q, k and v and write out once, 8 bytes per element of
// one (n, H·d) tensor: d / 2 = 32 operations per byte, far below the
// card's 295.  The plain form moves about 88 bytes per element (fp32
// copies, a strided softmax over n, casts, a relayout) in 14 launches.
// So the design streams each operand once and keeps everything else on
// chip:
//
// - linattn_context_kernel: grid (b·H, splits of n).  A block streams its
//   rows of k and v for one head straight from the strided views (row
//   stride 3·H·d in the to_qkv chunks: no copy) in 64-row tiles, through a
//   3-stage cp.async ring with the 128-byte swizzle.  Each warp owns 16 of
//   the 64 columns of k: it reads them transposed (ldmatrix .trans) as the
//   A operand of pᵀ·v, keeps a running max m and sum s per column in fp32
//   registers (the quad of lanes sharing a column agrees by two shuffles),
//   rescales its accumulator rows by exp(m_old − m_new) when the max
//   rises, and feeds p = exp(k − m), rounded to bf16, to mma.sync
//   (m16n8k16, bf16 in, fp32 out) against v's tile.  It writes (m, s, C)
//   per split to scratch.
// - linattn_reduce_kernel: per (b·h, column) the splits combined in index
//   order, then context = C / s rounded to bf16, as the plain path rounds
//   its context.
// - linattn_out_kernel: grid (b·H, splits of n).  The head's bf16 context
//   sits in shared memory as mma's B operand; q streams through a 4-stage
//   ring, each warp takes 16 rows, softmaxes them over d in fp32 registers
//   (row-local: two shuffles), multiplies by scale, rounds to bf16 and
//   multiplies by the context; out is staged in shared memory and written
//   as 16-byte rows of the contiguous (b, n, H·d) output.
//
// Bytes moved: k, v and q read once, out written once, plus the partials
// (b·H·splits·(64 + 64 + 4096) floats, 8.6 MB at b·H = 8 on 132 SMs).
// No float atomics: the splits are added in a fixed order, so a call
// repeats bit for bit.  Precision as the plain path's: statistics and
// accumulation in fp32, both operands of each product in bf16.
//
// Head dim 64 alone (every configuration of the port); any b, any n (the
// last tile is masked), any b·H.  Operands: bf16, last dimension
// contiguous, 16-byte aligned, row and batch strides multiples of 8
// elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of n per tile
constexpr int kRowBytes = kD * 2;
constexpr int kTileBytes = kTile * kRowBytes;  // 8 KB
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCtxStages = 3;   // (k, v) tile pairs in flight
constexpr int kOutStages = 4;   // q tiles in flight
constexpr int kReduceRows = 4;  // context rows per reduce block
constexpr int kBlocksPerSm = 4;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows, swizzled so that eight rows at one chunk hit eight bank groups
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * kRowBytes +
                               ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared; zeros where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a·b, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(x − m), with m·log2 e taken once per column
__device__ __forceinline__ float exp_shifted(float x, float m_log2) {
  return exp2f(fmaf(x, kLog2e, -m_log2));
}

// One head's 64-row tile of rows [row0, row_end) of a strided (b, n, H·d)
// operand into a swizzled shared tile: 512 chunks of 16 bytes, four a
// thread; rows past row_end are zeros.
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* head,
                                          long long row_stride, int row0,
                                          int row_end) {
#pragma unroll
  for (int i = 0; i < kTileBytes / 16 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 3, chunk = c & 7;
    const bool valid = row0 + row < row_end;
    const __nv_bfloat16* src =
        valid ? head + (row0 + row) * row_stride + chunk * 8 : head;
    cp_async16(tile + swz(row, chunk), src, valid);
  }
}

// ---------------------------------------------------------------- kernels

// Per (b·h, split): the split's running column max m, column sum s and
// context rows C = Σ_n exp(k − m)ᵀ·v, fp32, into the partials
// m, s (bh, splits, 64) and C (bh, splits, 64, 64).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
linattn_context_kernel(const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, long long skb,
                       long long skn, long long svb, long long svn, int n,
                       int heads, int rows_per_split,
                       float* __restrict__ part_m, float* __restrict__ part_s,
                       float* __restrict__ part_c) {
  __shared__ __align__(128) uint8_t smem[kCtxStages][2][kTileBytes];

  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix: lanes 8j..8j+7 address the rows of 8x8 matrix j; for the
  // operand rows r0..r0+15 and chunks c0, c0 + 1 of a 16x16 block, B's
  // matrices go (r0, c0), (r0 + 8, c0), (r0, c0 + 1), (r0 + 8, c0 + 1) and
  // kᵀ's (as A) (r0, c0), (r0, c0 + 1), (r0 + 8, c0), (r0 + 8, c0 + 1)
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_chunk = lane >> 4;
  const int kt_row = (lane & 7) + ((lane >> 4) << 3);
  const int kt_chunk = (lane >> 3) & 1;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kTile - 1) / kTile;
  const __nv_bfloat16* kh = k + b * skb + h * kD;
  const __nv_bfloat16* vh = v + b * svb + h * kD;

#pragma unroll
  for (int s = 0; s < kCtxStages - 1; ++s) {
    if (s < tiles) {
      load_tile(smem_u32(smem[s][0]), kh, skn, row_begin + s * kTile,
                row_end);
      load_tile(smem_u32(smem[s][1]), vh, svn, row_begin + s * kTile,
                row_end);
    }
    cp_async_commit();
  }

  // this lane's columns of k (rows of C): 16·warp + g and + 8
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kCtxStages - 2>();
    __syncthreads();  // tile t landed; tile t − 1's stage is free
    const int next = t + kCtxStages - 1;
    if (next < tiles) {
      const int s = next % kCtxStages;
      load_tile(smem_u32(smem[s][0]), kh, skn, row_begin + next * kTile,
                row_end);
      load_tile(smem_u32(smem[s][1]), vh, svn, row_begin + next * kTile,
                row_end);
    }
    cp_async_commit();

    const int stage = t % kCtxStages;
    const uint32_t kt = smem_u32(smem[stage][0]);
    const uint32_t vt = smem_u32(smem[stage][1]);
    const int valid = row_end - (row_begin + t * kTile);

    // kᵀ as the A operand: a[kk] covers rows n 16kk..16kk+15 of the tile;
    // registers 0/2 hold column 16·warp + g, 1/3 column + 8; n offsets
    // 2tq, 2tq + 1 (0, 1) and 8 more (2, 3)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4_t(a[kk], kt + swz(16 * kk + kt_row, 2 * warp + kt_chunk));
    }
    float x[2][16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n0 = 16 * kk + 2 * tq;
        x[r][4 * kk + 0] = n0 < valid ? bf16_lo(a[kk][r]) : -INFINITY;
        x[r][4 * kk + 1] = n0 + 1 < valid ? bf16_hi(a[kk][r]) : -INFINITY;
        x[r][4 * kk + 2] = n0 + 8 < valid ? bf16_lo(a[kk][r + 2])
                                          : -INFINITY;
        x[r][4 * kk + 3] = n0 + 9 < valid ? bf16_hi(a[kk][r + 2])
                                          : -INFINITY;
      }
    }
    float m_log2[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = x[r][0];
#pragma unroll
      for (int i = 1; i < 16; ++i) tile_max = fmaxf(tile_max, x[r][i]);
      const float m_new = fmaxf(m[r], quad_max(tile_max));
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);  // 0 at the first tile
      m[r] = m_new;
      m_log2[r] = m_new * kLog2e;
      sum[r] *= alpha[r];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }
    // p = exp(k − m) (0 past the rows), summed in fp32, bf16 for the mma
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi = x[r][4 * kk + i];
          p[i] = xi == -INFINITY ? 0.f : exp_shifted(xi, m_log2[r]);
          sum[r] += p[i];
        }
        a[kk][r] = pack_bf16(p[0], p[1]);
        a[kk][r + 2] = pack_bf16(p[2], p[3]);
      }
    }
    // C += pᵀ·v: v's tile as the B operand (rows n, transposed loads),
    // two 8-column blocks of C per load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + swz(16 * kk + b_row, 2 * jj + b_chunk));
        mma_bf16(acc[2 * jj], a[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * jj + 1], a[kk], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t part = (size_t)bh * splits + split;
  const int d0 = 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s = quad_sum(sum[r]);
    if (tq == 0) {
      part_m[part * kD + d0 + 8 * r] = m[r];
      part_s[part * kD + d0 + 8 * r] = s;
    }
  }
  float* c = part_c + part * kD * kD;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(c + (size_t)d0 * kD + e) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(c + (size_t)(d0 + 8) * kD + e) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// context (bh, 64, 64) bf16 = Σ_split e^(m_split − M)·C_split / Σ_split
// e^(m_split − M)·s_split, the splits taken in index order (M: the running
// max); a block holds kReduceRows rows, a thread one entry.
__global__ void __launch_bounds__(kReduceRows * kD)
linattn_reduce_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_s,
                      const float* __restrict__ part_c, int splits,
                      __nv_bfloat16* __restrict__ context) {
  const int bh = blockIdx.x;
  const int d = blockIdx.y * kReduceRows + threadIdx.x / kD;
  const int e = threadIdx.x % kD;
  float run_m = -INFINITY, run_s = 0.f, run_c = 0.f;
#pragma unroll 8
  for (int j = 0; j < splits; ++j) {
    const size_t row = ((size_t)bh * splits + j) * kD + d;
    const float mj = part_m[row];
    const float m_new = fmaxf(run_m, mj);
    const float keep = exp2f((run_m - m_new) * kLog2e);  // 0 at j = 0
    const float take = exp2f((mj - m_new) * kLog2e);
    run_s = run_s * keep + part_s[row] * take;
    run_c = run_c * keep + part_c[row * kD + e] * take;
    run_m = m_new;
  }
  context[((size_t)bh * kD + d) * kD + e] = __float2bfloat16_rn(run_c / run_s);
}

// out (b, n, H·d) contiguous: per row, softmax over d of q times scale,
// rounded to bf16, times the head's bf16 context, fp32 accumulation.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
linattn_out_kernel(const __nv_bfloat16* __restrict__ q, long long sqb,
                   long long sqn, const __nv_bfloat16* __restrict__ context,
                   __nv_bfloat16* __restrict__ out, int n, int heads,
                   int rows_per_split, float scale) {
  __shared__ __align__(128) uint8_t qs[kOutStages][kTileBytes];
  __shared__ __align__(128) uint8_t ctx[kTileBytes];
  __shared__ __align__(128) uint8_t staged[kTileBytes];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix rows and chunks: q (A, as stored) and the context (B,
  // transposed) take the same four 8x8 matrices of a 16x16 block, (r0, c0),
  // (r0 + 8, c0), (r0, c0 + 1), (r0 + 8, c0 + 1)
  const int l_row = (lane & 7) + (((lane >> 3) & 1) << 3), l_chunk = lane >> 4;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tiles = (row_end - row_begin + kTile - 1) / kTile;
  const __nv_bfloat16* qh = q + b * sqb + h * kD;
  const long long hd = (long long)heads * kD;
  __nv_bfloat16* oh = out + (long long)b * n * hd + h * kD;

  // the context (64 rows of 64) with the first tile's group
  load_tile(smem_u32(ctx), context + (size_t)bh * kD * kD, kD, 0, kD);
#pragma unroll
  for (int s = 0; s < kOutStages - 1; ++s) {
    if (s < tiles) {
      load_tile(smem_u32(qs[s]), qh, sqn, row_begin + s * kTile, row_end);
    }
    cp_async_commit();
  }

  const uint32_t ct = smem_u32(ctx);
  uint8_t* mine = staged + warp * 16 * kRowBytes;  // this warp's 16 rows
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kOutStages - 2>();
    __syncthreads();
    const int next = t + kOutStages - 1;
    if (next < tiles) {
      load_tile(smem_u32(qs[next % kOutStages]), qh, sqn,
                row_begin + next * kTile, row_end);
    }
    cp_async_commit();

    // q as the A operand: the warp's rows 16·warp + g (registers 0/2)
    // and + 8 (1/3); a[kk] covers columns 16kk..16kk+15
    const uint32_t qt = smem_u32(qs[t % kOutStages]);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(a[kk], qt + swz(16 * warp + l_row, 2 * kk + l_chunk));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        x[4 * kk + 0] = bf16_lo(a[kk][r]);
        x[4 * kk + 1] = bf16_hi(a[kk][r]);
        x[4 * kk + 2] = bf16_lo(a[kk][r + 2]);
        x[4 * kk + 3] = bf16_hi(a[kk][r + 2]);
      }
      float row_max = x[0];
#pragma unroll
      for (int i = 1; i < 16; ++i) row_max = fmaxf(row_max, x[i]);
      const float m_log2 = quad_max(row_max) * kLog2e;
      float row_sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[i] = exp_shifted(x[i], m_log2);
        row_sum += x[i];
      }
      const float inv = scale / quad_sum(row_sum);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][r] = pack_bf16(x[4 * kk + 0] * inv, x[4 * kk + 1] * inv);
        a[kk][r + 2] = pack_bf16(x[4 * kk + 2] * inv, x[4 * kk + 3] * inv);
      }
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bc[4];
        ldsm_x4_t(bc, ct + swz(16 * kk + l_row, 2 * jj + l_chunk));
        mma_bf16(acc[2 * jj], a[kk], bc[0], bc[1]);
        mma_bf16(acc[2 * jj + 1], a[kk], bc[2], bc[3]);
      }
    }
    // bf16 rows through shared memory, then 16-byte stores
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(mine + swz(g, j) + 4 * tq) =
          pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(mine + swz(g + 8, j) + 4 * tq) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    const int row0 = row_begin + t * kTile + 16 * warp;
#pragma unroll
    for (int i = 0; i < 16 * 8 / 32; ++i) {
      const int c = lane + 32 * i;
      const int row = c >> 3, chunk = c & 7;
      if (row0 + row < row_end) {
        *reinterpret_cast<uint4*>(oh + (row0 + row) * hd + chunk * 8) =
            *reinterpret_cast<const uint4*>(mine + swz(row, chunk));
      }
    }
    __syncwarp();  // the rows are read before the next tile writes them
  }
  cp_async_wait<0>();
}

// rows of n per split: splits fill about kBlocksPerSm blocks per SM over
// the b·h heads, whole tiles each
inline int rows_per_split_for(int bh, int n, int sms) {
  const long tiles = (n + kTile - 1) / kTile;
  long splits = (long)kBlocksPerSm * sms / bh;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  return (int)((tiles + splits - 1) / splits * kTile);
}

}  // namespace

// Rows of n each split of the grid takes (a multiple of 64), the same for
// the context and the output kernel; the call needs b·H·splits·(2 + 64)·64
// floats of scratch, splits = ceil(n / rows).  Returns <= 0 on a CUDA
// error.
extern "C" int gigagan_linattn_rows_per_split(int bh, int n, int device) {
  int sms = 0;
  if (bh <= 0 || n <= 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return rows_per_split_for(bh, n, sms);
}

// Three launches: linattn_context_kernel, linattn_reduce_kernel,
// linattn_out_kernel.  Strides in elements.  `partials` holds the m, s and
// C partials one after another (bh·splits·64, bh·splits·64 and
// bh·splits·64·64 floats), `context` b·H·64·64 bf16.  Returns a
// cudaError_t.
extern "C" int gigagan_linear_attention(
    const void* q, const void* k, const void* v, void* out, void* partials,
    void* context, int b, int n, int heads, long long sqb, long long sqn,
    long long skb, long long skn, long long svb, long long svn,
    int rows_per_split, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long strides[6] = {sqb, sqn, skb, skn, svb, svn};
  const void* pointers[4] = {q, k, v, out};
  bool aligned = true;
  for (long long s : strides) aligned = aligned && s % 8 == 0;
  for (const void* p : pointers) {
    aligned = aligned && p != nullptr &&
              reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  const long long bh = (long long)b * heads;
  const long long splits =
      rows_per_split > 0 ? (n + (long long)rows_per_split - 1) / rows_per_split
                         : 0;
  if (!aligned || b <= 0 || n <= 0 || heads <= 0 || bh > 0x7fffffff ||
      rows_per_split <= 0 || rows_per_split % kTile != 0 || splits > 65535 ||
      partials == nullptr || context == nullptr) {
    return cudaErrorInvalidValue;
  }
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  float* part_m = static_cast<float*>(partials);
  float* part_s = part_m + bh * splits * kD;
  float* part_c = part_s + bh * splits * kD;
  auto* ctx = static_cast<__nv_bfloat16*>(context);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)bh, (unsigned)splits);
  linattn_context_kernel<<<grid, kThreads, 0, st>>>(
      kb, vb, skb, skn, svb, svn, n, heads, rows_per_split, part_m, part_s,
      part_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linattn_reduce_kernel<<<dim3((unsigned)bh, kD / kReduceRows),
                          kReduceRows * kD, 0, st>>>(
      part_m, part_s, part_c, (int)splits, ctx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linattn_out_kernel<<<grid, kThreads, 0, st>>>(
      qb, sqb, sqn, ctx, static_cast<__nv_bfloat16*>(out), n, heads,
      rows_per_split, scale);
  return cudaGetLastError();
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
