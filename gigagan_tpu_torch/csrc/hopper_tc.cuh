// Hopper (sm_90a) building blocks of the tensor-core kernels
// (adaptive_conv_fwd_tc.cu, adaptive_conv_bwd_w_tc.cu,
// flash_attention_fused_fwd_tc.cu, flash_attention_fused_bwd_tc.cu,
// flash_attention_so_bwd2_tc.cu, and through flash_attention_hv_tc.cuh the
// K7a/K7b ones): TMA tensor maps and loads, mbarriers, `wgmma` with
// shared-memory descriptors, and register reallocation between warpgroups.
// The conv kernels' tiles of 16- and 32-channel rows use the 32- and
// 64-byte swizzles (`swizzle_for`, `desc_rows`, K-major and MN-major), the
// rest the layout below.
//
// Tile layout.  Every operand tile is a stack of (64 rows, 64 bf16) boxes of
// 8 KB ("atoms"), each loaded by one TMA copy with the 128-byte swizzle: row
// r of an atom sits at r·128 bytes, and its 16-byte chunk c at chunk
// c ^ (r % 8).  Atoms start on 1024-byte boundaries.  A head dim of 64 is one
// atom per 64 rows, 128 is two (columns 0-63, then 64-127).  The same atom
// serves `wgmma` both ways:
//
// - K-major (the reduced dimension runs along the row): descriptor with the
//   128-byte swizzle, SBO = 1024 bytes (8 rows), and the 16-column step of
//   the reduction taken by adding 32 bytes to the start address;
// - MN-major (the reduced dimension runs down the rows, for the B operand of
//   P·V-like products, transpose bit set): SBO = 1024 bytes (8 reduced rows),
//   LBO = the atom stride, and the 16-row step taken by adding 2048 bytes.
//
// The accumulator of a m64nNk16 product lives in a warpgroup as FlashAttention
// kernels on Hopper keep it: thread t (warp w = t / 32, lane l = t % 32) holds
// rows 16w + l/4 (i = 0) and 16w + l/4 + 8 (i = 1), columns 8j + 2(l % 4) + c,
// in register 4j + 2i + c.  The four lanes of a quad share a row, so a row
// reduction is two shuffles.  Registers 8kk .. 8kk+7, rounded to bf16 in
// pairs, are the A fragment of a k = 16 step over columns 16kk .. 16kk+15.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kAtomRows = 64;
constexpr int kAtomBytes = kAtomRows * 128;  // (64, 64) bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The bias of a masked key: NEG_INF = −0.7·FLT_MAX rounded to fp32, as
// `prep_split` (ops/kernels/flash_attention.py) writes it.
constexpr float kMasked = -0x1.666664p+127f;

// A bias or lse taken to the log2 domain of the softmax kernels.  A masked
// key's bias times log2 e overflows to −inf, and a row whose every key is
// masked would then give exp2(−inf − (−inf)) = NaN.  Clamped to kMasked,
// every logit of such a row is kMasked: P = 1 at every key, the row's mean
// of v, and lse = kMasked (the forward writes it back as is), which is what
// the plain version and the CUDA-core kernels give.  Every value above
// kMasked / log2 e (any unmasked bias, any finite lse) passes unchanged.
__device__ __forceinline__ float to_log2(float x) {
  return fmaxf(x * kLog2e, kMasked);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query (so the library needs no link against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A map over a (b, n, H·d) bf16 tensor read in place: dims (H·d, n, b),
// box (64 columns, 64 rows, 1 sample), 128-byte swizzle.  Rows past n are
// zero-filled, so a tile never reads the next sample.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int b, int n,
                            int hd) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)n * (cuuint64_t)hd * 2};
  const cuuint32_t box[3] = {64, kAtomRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The swizzle that matches a row of `row_bytes` (32, 64 or 128): TMA and
// `wgmma` both apply it to shared-memory address bits, so a tile base must
// sit on a multiple of 8 rows (256, 512 or 1024 bytes).
inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A map over a channels-last (b, h, w, c) bf16 activation: dims (c, w, h, b),
// box (ck channels, bw pixels, bh rows, 1 sample), the swizzle of a
// 2·ck-byte row.  Coordinates may be negative or run past the map: TMA
// fills those elements with zeros, which is a conv's SAME padding, so a
// shifted tile is one box and no padded copy of the activation exists.
inline cudaError_t make_map_nhwc(CUtensorMap* map, const void* ptr, int b,
                                 int h, int w, int c, int ck, int bw, int bh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ck, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(2 * ck),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a byte count that disagrees with the copies) traps, so a fault ends
// the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 30)) __trap();
  }
}

// one (64, 64) box of a 3-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(batch)
      : "memory");
}

// one box of a 4-D map (make_map_nhwc) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (`wgmma` operands written by threads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of a 16-byte chunk under the swizzle of RB-byte rows, for a
// tile whose base sits on a multiple of 8 rows
template <int RB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier among the consumer warpgroups only (id 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a tile of RB-byte rows (RB = 32, 64 or
// 128 with the matching swizzle), SBO = 8 rows.  K-major (the reduced
// dimension along the row): LBO is unused, and the 16-column step of the
// reduction is +32 bytes on the address.  MN-major (the reduced dimension
// down the rows, transpose bit set): the RB / 2 bf16 of a row are one group
// along M or N, a 64-wide M or N spans 128 / RB such groups LBO bytes apart
// (so groups may come from separate TMA boxes laid out at one stride), and
// the 16-row step of the reduction is +16·RB bytes on the address.
template <int RB>
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr,
                                              uint32_t lbo_bytes = 16) {
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((8 * RB) >> 4) << 32;  // SBO: 8 rows
  d |= layout << 62;
  return d;
}

// the same with the 128-byte swizzle, the atoms' layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes) {
  return desc_rows<128>(addr, lbo_bytes);
}

// K-major operand at column step kk (16 columns) of a stack of atoms
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * kAtomBytes + (kk % 4) * 32, 16);
}

// MN-major operand at row step kk (16 rows) of the atom holding columns
// 64a .. 64a+63
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int a, int kk) {
  return desc(tile + a * kAtomBytes + kk * 2048, kAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the asynchronous
// products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define TC_REGS32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A·B, m64n64k16, bf16 in, fp32 accumulate; A and B in shared
// memory, K-major unless their transpose bit TA / TB is 1 (MN-major: A's M
// or B's N along the rows, the reduction down them).  accumulate = 0
// overwrites d.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : TC_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A·B, m64n64k16: A from registers (four bf16 pairs), B MN-major in
// shared memory (transpose bit set)
__device__ __forceinline__ void mma_rs_t(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A·B for the narrower N of thin output channels and of half-width
// attention pieces: m64n16k16 and m64n32k16, operands and transpose bits as
// mma_ss's; accumulate = 0 overwrites d
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss16(float (&d)[8], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A·B, m64nNk16 with N = 16, 32 or 64, both operands K-major unless
// TA / TB set their transpose bits
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss_n(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate = 1) {
  if constexpr (N == 16) {
    mma_ss16<TA, TB>(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    mma_ss32<TA, TB>(d, a, b, accumulate);
  } else {
    mma_ss<TA, TB>(d, a, b, accumulate);
  }
}

#undef TC_ACC32
#undef TC_REGS32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of a (64, 64) fp32 accumulator, rounded to bf16: four
// k = 16 steps of four registers
__device__ __forceinline__ void to_frags(const float (&s)[32],
                                         uint32_t (&f)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) f[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the 8 bf16 at columns 8ch .. 8ch+7 of row `row` of a tile whose atoms of
// 64 rows are stacked per row block: [row / 64][column atom][64][64]
template <int DA>
__device__ __forceinline__ uint4 tile_chunk(const uint8_t* tile, int row,
                                            int ch) {
  const int r = row % kAtomRows;
  const uint8_t* atom =
      tile + ((row / kAtomRows) * DA + ch / 8) * kAtomBytes + r * 128;
  return *reinterpret_cast<const uint4*>(atom + (((ch % 8) ^ (r % 8)) * 16));
}

__device__ __forceinline__ float tile_at(const uint8_t* tile, int da, int row,
                                         int col) {
  const int r = row % kAtomRows;
  const uint8_t* atom =
      tile + ((row / kAtomRows) * da + col / 64) * kAtomBytes + r * 128;
  const int c = col % 64;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      atom + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2));
}

// Σ over 8 columns of x ⊙ y, x a chunk of bf16, y 8 bf16 in global memory
__device__ __forceinline__ float dot8(uint4 x, const __nv_bfloat16* y) {
  const uint4 yv = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&yv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xa[i]);
    const float2 b = __bfloat1622float2(ya[i]);
    s = fmaf(a.x, b.x, fmaf(a.y, b.y, s));
  }
  return s;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

}  // namespace tc
