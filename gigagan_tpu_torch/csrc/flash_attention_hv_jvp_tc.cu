// Split-heads attention and its tangent on Hopper's tensor cores (kernel
// K7a, the bf16 route at head dim 64).
//
// Replaces the Pallas TPU kernel `_jvp_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_hv.py (called through
// `_jvp_impl`), as flash_attention_hv_jvp.cu does on CUDA cores for fp32
// and the other head dims.  On K6a's prepared operands (q, k̂ = coeff·k, v,
// bias) and their tangents (tq, t̂k = coeff·tk, tv, tbias), per (b·h):
//
//   S = q k̂ᵀ + bias   T = [tq | q]·[k̂ | t̂k]ᵀ + tbias   A = softmax(S)
//   μ = rowsum(A⊙T)   out = A v   tout = [A⊙(T − μ) | A]·[v ; tv]
//   lse = logsumexp(S)
//
// What bounds it on an H100: six (n, n, 64) products a call, operation-
// bound at the R1 surrogate's shapes (b·h = 512 at n = 1024, 1024 at 256:
// ~0.5 ms at 989 TF/s), and S, T and A must not reach device memory.
//
// Design (flash_attention_hv_tc.cuh; K3-_tc's online softmax): one block
// per (128 queries, b·h); q and tq stay in shared memory, and k̂, t̂k, v, tv
// stream through a four-stage TMA ring of 64-key tiles with the tile's
// bias (log2 domain, −inf past nk) and tbias (0 past nk) rows.  Each tile
// is taken in two 32-key pieces: S and T are two `wgmma` chains (T one
// chain of depth 2·64 over [tq | q] and [k̂ | t̂k], so one accumulator),
// then the online softmax on the fragment, and out += e·v and
// tout += [e⊙(T − c) | e]·[v ; tv] from registers with v and tv MN-major.
//
// One pass over the keys, where the CUDA-core kernel makes two.  The
// tangent accumulator is kept centred on c, the running μ = Σ e·T / Σ e of
// the keys so far: when a piece moves c by Δc, tout −= Δc·out (fp32), and
// the piece's e⊙(T − c) is rounded to bf16 around the new c.  At the end
// c = μ, so tout needs no Σ A T v − μ Σ A v cancellation, and the bf16
// rounding of each piece is relative to |T − c| as the TPU kernel's is to
// |T − μ|.  e and e⊙(T − c) are rounded to bf16 for their products, as the
// TPU kernel casts A and A⊙(T − μ) for the MXU; logits, the statistics and
// the accumulators stay fp32.  A masked key's bias (NEG_INF) goes through
// `to_log2`, so a row whose every key is masked stays finite (the mean of v
// and tv, lse = NEG_INF), as K3-_tc's does.
//
// Registers: out and tout are two (64 × 64) fp32 accumulators, 64 a
// thread, beside the 16 of each piece map; at d = 128 the accumulators
// alone would take 128 of the 168, so d = 128 stays on the CUDA cores.

#include <math.h>

#include "flash_attention_hv_tc.cuh"

namespace {

using namespace hv;

using L = Layout<2, 4, 2, 4>;  // q, tq | k̂, t̂k, v, tv | bias, tbias

__global__ void __launch_bounds__(kThreads, 1)
hv_jvp_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap tqmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap tkmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap tvmap,
                 const float* __restrict__ bias,
                 const float* __restrict__ tbias,
                 __nv_bfloat16* __restrict__ out,
                 __nv_bfloat16* __restrict__ tout, float* __restrict__ lse,
                 int nq, int nk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const Bars bars = init_bars(base + L::kBars, L::kStages);

  const int q0 = blockIdx.x * kBlockRows;
  const int bi = blockIdx.y;
  const int ntiles = (nk + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t keys0 = (size_t)bi * nk;

  if (warp == kConsumers / 32) {
    const CUtensorMap* res[2] = {&qmap, &tqmap};
    const CUtensorMap* str[4] = {&kmap, &tkmap, &vmap, &tvmap};
    produce(bars, base, res, 2, str, 4, q0, bi, ntiles, ntiles, L::kRing,
            L::kStage, [&](int s, int t) {
              stage_key_rows(vec + s * L::kVecStage, bias + keys0,
                             tbias + keys0, t * kCols, nk);
            });
    return;
  }

  const int wg = warp / 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;  // rows r_lo, r_lo + 8
  const int cq2 = 2 * (lane % 4);
  const int row_blk = 64 * wg + r_lo;
  const uint32_t qw = base + wg * kAtomBytes;
  const uint32_t tqw = base + kRes + wg * kAtomBytes;

  // per row: running max (log2 domain), Σ e, Σ e·T and the centre c =
  // Σ e·T / Σ e, all quad-wide
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
        lt[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  float o[32], to[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) o[r] = to[r] = 0.f;
  mbar_wait(bars.res, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(bars.full(s), (t / L::kStages) & 1);
    const uint32_t ks = base + L::kRing + s * L::kStage;
    const uint32_t tks = ks + kTile, vs = ks + 2 * kTile,
                   tvs = ks + 3 * kTile;
#pragma unroll 1
    for (int hf = 0; hf < kCols / KP; ++hf) {
      const uint32_t ko = hf * KP * 128;  // the piece's first key row
      const int k16 = hf * KP / 16;       // its first 16-key step
      float sa[KP / 2], ta[KP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(sa, desc_k(qw, kk), desc_k(ks + ko, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(ta, desc_k(tqw, kk), desc_k(ks + ko, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n<KP>(ta, desc_k(qw, kk), desc_k(tks + ko, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
      fence_acc(ta);

      const float* bv = vec + s * L::kVecStage + hf * KP;
      uint32_t ef[KP / 4], tf[KP / 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KP / 8; ++j) {
          const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq2);
          const float2 t2 =
              *reinterpret_cast<const float2*>(bv + kCols + 8 * j + cq2);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            sa[r] = fmaf(sa[r], kLog2e, cc ? b2.y : b2.x);
            ta[r] += cc ? t2.y : t2.x;
            mx = fmaxf(mx, sa[r]);
          }
        }
        // the first piece holds key 0, so m_new is finite from there on
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float alpha = exp2f(m[i] - m_new);  // 0 while m is −inf
        float pe = 0.f, pet = 0.f;
#pragma unroll
        for (int j = 0; j < KP / 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            const float e = exp2f(sa[r] - m_new);  // past nk: 0
            sa[r] = e;
            pe += e;
            pet = fmaf(e, ta[r], pet);
          }
        const float l_new = fmaf(l[i], alpha, quad_sum(pe));
        const float lt_new = fmaf(lt[i], alpha, quad_sum(pet));
        const float c_new = lt_new / l_new;
        const float dc = c_new - c[i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 4 * j + 2 * i + cc;
            o[r] *= alpha;
            to[r] = fmaf(-dc, o[r], to[r] * alpha);
          }
        m[i] = m_new;
        l[i] = l_new;
        lt[i] = lt_new;
        c[i] = c_new;
#pragma unroll
        for (int j = 0; j < KP / 8; ++j) {
          const int r = 4 * j + 2 * i;
          ef[2 * j + i] = pack_bf16(sa[r], sa[r + 1]);
          tf[2 * j + i] = pack_bf16(sa[r] * (ta[r] - c_new),
                                    sa[r + 1] * (ta[r + 1] - c_new));
        }
      }
      // out += e·v; tout += [e⊙(T − c) | e]·[v ; tv]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(o, ef + 4 * kk, desc_mn(vs, 0, k16 + kk));
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(to, tf + 4 * kk, desc_mn(vs, 0, k16 + kk));
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        mma_rs_t(to, ef + 4 * kk, desc_mn(tvs, 0, k16 + kk));
      wgmma_commit();
      wgmma_wait();
      fence_acc(o);
      fence_acc(to);
    }
    mbar_arrive(bars.empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_blk + 8 * i;
    if (row >= nq) continue;
    const float inv = 1.f / l[i];
    const size_t off = ((size_t)bi * nq + row) * kD;
    store_row(out + off, o, i, inv);
    store_row(tout + off, to, i, inv);  // centred on c = μ
    // a row whose every key is masked keeps lse = NEG_INF (`to_log2`)
    if (lane % 4 == 0)
      lse[(size_t)bi * nq + row] =
          m[i] == kMasked ? kMasked : (m[i] + log2f(l[i])) * kLn2;
  }
}

}  // namespace

// bf16 (bh, n, 64) operands, 16-byte aligned; bias and tbias (bh, nk)
// fp32; out and tout bf16 like q, lse (bh, nq) fp32.  The dtype code must
// be 1 (bfloat16) and d 64.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_hv_jvp_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* tq, const void* tk, const void* tv, const void* tbias,
    void* out, void* tout, void* lse, int bh, int nq, int nk, int d,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d != kD || dtype != 1)
    return cudaErrorInvalidValue;
  CUtensorMap qm, tqm, km, tkm, vm, tvm;
  err = make_map(&qm, q, bh, nq, kD);
  if (err == cudaSuccess) err = make_map(&tqm, tq, bh, nq, kD);
  if (err == cudaSuccess) err = make_map(&km, k, bh, nk, kD);
  if (err == cudaSuccess) err = make_map(&tkm, tk, bh, nk, kD);
  if (err == cudaSuccess) err = make_map(&vm, v, bh, nk, kD);
  if (err == cudaSuccess) err = make_map(&tvm, tv, bh, nk, kD);
  if (err == cudaSuccess) err = set_smem(hv_jvp_tc_kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockRows - 1) / kBlockRows, bh);
  hv_jvp_tc_kernel<<<grid, kThreads, L::kBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      qm, tqm, km, tkm, vm, tvm, static_cast<const float*>(bias),
      static_cast<const float*>(tbias), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(tout), static_cast<float*>(lse), nq, nk);
  return cudaGetLastError();
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
