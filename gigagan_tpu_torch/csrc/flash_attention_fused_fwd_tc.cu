// Fused-heads flash attention forward with an analytic null key/value on
// Hopper's tensor cores (kernel K3, the bf16 route for head dims 64 and 128).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// gigagan_tpu/ops/pallas/flash_attention_fused.py (called through
// `_fwd_impl`), as flash_attention_fused_fwd.cu does on CUDA cores for the
// other cases.  The function is that file's: on PREPARED operands (k_pre =
// coeff·k, an fp32 bias row for L2 similarity, the null token as per-head
// rows), per head h
//
//   sim  = q·k_preᵀ + bias        null = q·nullk_pre[h] + null_bias[h]
//   out  = softmax([null, sim]) · [nullv[h]; v],  lse = logsumexp([null, sim])
//
// Layouts: q (b, nq, H·d), k_pre/v (b, nk, H·d) bf16, read in place through
// 3-D TMA maps over (H·d, n, b) at column h·d; bias (b, H, nk) f32 or null;
// nullk_pre/nullv (H, d) bf16; null_bias (H,) f32; out (b, nq, H·d) bf16;
// lse (b, H, nq) f32, which K4 and K5 read.
//
// The same kernel is K6a's bf16 route for head dims 64 and 128 (the
// split-heads forward, replacing `_fwd_kernel` of
// gigagan_tpu/ops/pallas/flash_attention.py, called through
// `_flash_fwd_impl`): K6a's (b·h, n, d) operands are this layout with H = 1
// and b = b·h, its (b·h, nk) bias this bias with H = 1, and it has no null
// token.  Its bias holds NEG_INF at masked keys; `to_log2` keeps a row whose
// every key is masked finite (the mean of v, lse = NEG_INF).
//
// What bounds it on an H100: 4·n²·d FLOPs per (sample, head) against
// 4·n·d bytes of operands, so it is compute-bound at the discriminator's
// shapes (n = 1024: ~0.14 ms of bf16 tensor-core work for the d_step's
// b·H = 512 at 989 TF/s).  Design (FlashAttention-3's shape, simplified):
// one block per (128 query rows, head, sample) of three warpgroups.  The
// producer warpgroup gives up its registers (`setmaxnreg`), and one warp of
// it keeps a ring of K/V tiles (64 keys) full by TMA, completing on
// `mbarrier`s; it also stages the tile's bias row (scaled by log2 e, −inf
// past nk).  Two consumer warpgroups of 64 query rows each run
// S = Q·K̂ᵀ on `wgmma` (both operands K-major in shared memory), the online
// softmax on the accumulator fragment (seeded with the analytic null
// column: m₀ = null logit, l₀ = 1, acc₀ = nullv), round P to bf16 in
// registers as the TPU kernel rounds it for the MXU, and accumulate
// O += P·V with P from registers and V MN-major from shared memory.  Logits,
// the running statistics and the accumulator stay fp32.  The products and
// the softmax of one warpgroup overlap the other's; the ragged nq/nk are
// zero-filled by TMA and masked by column.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace tc;

constexpr int kConsumers = 256;  // two warpgroups of 64 query rows
constexpr int kThreads = 384;    // + the producer warpgroup
constexpr int kBlockRows = 128;
constexpr int kKeys = 64;        // keys per ring stage

template <int DA>
struct Layout {
  static constexpr int kStages = DA == 1 ? 4 : 3;
  static constexpr int kQ = 2 * DA * kAtomBytes;         // [wg][atom]
  static constexpr int kKV = DA * kAtomBytes;            // one K or V tile
  static constexpr int kStage = 2 * kKV;                 // K, then V
  static constexpr int kVec = kQ + kStages * kStage;     // bias rows
  static constexpr int kBars = kVec + kStages * kKeys * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DA>
__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ nullk,
                    const __nv_bfloat16* __restrict__ nullv,
                    const float* __restrict__ null_bias,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int nq, int nk, int heads, int have_null) {
  using L = Layout<DA>;
  constexpr int D = 64 * DA;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  const uint32_t qbar = base + L::kBars;
  auto full = [&](int s) { return qbar + 8 * (1 + s); };
  auto empty = [&](int s) { return qbar + 8 * (1 + S + s); };

  const int q0 = blockIdx.x * kBlockRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int ntiles = (nk + kKeys - 1) / kKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: one warp loads, the rest only give up
    // their registers
    setmaxnreg_dec<40>();
    if (warp == kConsumers / 32) {
      const float* bias_b =
          bias ? bias + ((size_t)bi * heads + hh) * nk : nullptr;
      if (lane == 0) {
        mbar_arrive_tx(qbar, L::kQ);
        for (int wg = 0; wg < 2; ++wg)
          for (int a = 0; a < DA; ++a)
            tma_load(q_s + (wg * DA + a) * kAtomBytes, &qmap, qbar,
                     hh * D + 64 * a, q0 + 64 * wg, bi);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), ((t / S) - 1) & 1);
        const int k0 = t * kKeys;
        for (int c = lane; c < kKeys; c += 32) {
          const int key = k0 + c;
          vec[s * kKeys + c] =
              key < nk ? (bias_b ? to_log2(bias_b[key]) : 0.f) : -INFINITY;
        }
        if (lane == 0) {
          mbar_arrive_tx(full(s), L::kStage);
          const uint32_t st = kv_s + s * L::kStage;
          for (int a = 0; a < DA; ++a) {
            tma_load(st + a * kAtomBytes, &kmap, full(s), hh * D + 64 * a, k0,
                     bi);
            tma_load(st + L::kKV + a * kAtomBytes, &vmap, full(s),
                     hh * D + 64 * a, k0, bi);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- two consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = warp / 4;
    const int r_lo = (warp % 4) * 16 + lane / 4;  // rows r_lo, r_lo + 8
    const int cq = 2 * (lane % 4);
    const uint32_t qw = q_s + wg * DA * kAtomBytes;
    const int row_blk = 64 * wg + r_lo;  // row in the block (i = 0)

    float m[2], l[2], o[DA][32];
    mbar_wait(qbar, 0);
    if (have_null) {
      // the null token: one analytic logit per row, split over the quad
      const __nv_bfloat16* nk_h = nullk + (size_t)hh * D;
      const __nv_bfloat16* nv_h = nullv + (size_t)hh * D;
      const float nb = null_bias[hh];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float part = 0.f;
#pragma unroll
        for (int ch = lane % 4; ch < D / 8; ch += 4)
          part += dot8(tile_chunk<DA>(smem, row_blk + 8 * i, ch),
                       nk_h + 8 * ch);
        m[i] = (quad_sum(part) + nb) * kLog2e;
        l[i] = lane % 4 == 0 ? 1.f : 0.f;  // partial sums, reduced at the end
      }
#pragma unroll
      for (int a = 0; a < DA; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 nv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(nv_h + 64 * a + 8 * j +
                                                       cq));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[a][4 * j + 2 * i] = nv.x;
            o[a][4 * j + 2 * i + 1] = nv.y;
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < DA; ++a)
#pragma unroll
        for (int r = 0; r < 32; ++r) o[a][r] = 0.f;
    }

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      mbar_wait(full(s), (t / S) & 1);
      const uint32_t ks = kv_s + s * L::kStage;
      const uint32_t vs = ks + L::kKV;

      float sacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DA; ++kk)
        mma_ss(sacc, desc_k(qw, kk), desc_k(ks, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_acc(sacc);

      // online softmax in the log2 domain on the accumulator fragment
      const float* bv = vec + s * kKeys;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b2 = *reinterpret_cast<const float2*>(bv + 8 * j + cq);
          float& s0 = sacc[4 * j + 2 * i];
          float& s1 = sacc[4 * j + 2 * i + 1];
          s0 = fmaf(s0, kLog2e, b2.x);
          s1 = fmaf(s1, kLog2e, b2.y);
          mx = fmaxf(mx, fmaxf(s0, s1));
        }
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float alpha = exp2f(m[i] - m_new);  // 0 while m is −inf
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& sv = sacc[4 * j + 2 * i + c];
            sv = exp2f(sv - m_new);  // masked keys: exp2(−inf) = 0
            sum += sv;
          }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int a = 0; a < DA; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[a][4 * j + 2 * i] *= alpha;
            o[a][4 * j + 2 * i + 1] *= alpha;
          }
      }

      uint32_t pf[16];
      to_frags(sacc, pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < DA; ++a)
          mma_rs_t(o[a], pf + 4 * kk, desc_mn(vs, a, kk));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int a = 0; a < DA; ++a) fence_acc(o[a]);
      mbar_arrive(empty(s));
    }

    const size_t hd = (size_t)heads * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_tot = quad_sum(l[i]);
      const int row = q0 + row_blk + 8 * i;
      if (row >= nq) continue;
      const float inv = 1.f / l_tot;
      __nv_bfloat16* orow = out + ((size_t)bi * nq + row) * hd + (size_t)hh * D;
#pragma unroll
      for (int a = 0; a < DA; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * a + 8 * j + cq) =
              __floats2bfloat162_rn(o[a][4 * j + 2 * i] * inv,
                                    o[a][4 * j + 2 * i + 1] * inv);
      // a row whose every key is masked keeps lse = NEG_INF (`to_log2`)
      if (lane % 4 == 0)
        lse[((size_t)bi * heads + hh) * nq + row] =
            m[i] == kMasked ? kMasked : (m[i] + log2f(l_tot)) * kLn2;
    }
  }
}

template <int DA>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const void* nullk, const void* nullv,
                   const float* null_bias, void* out, float* lse, int b,
                   int nq, int nk, int heads, int have_null,
                   cudaStream_t stream) {
  const int hd = heads * 64 * DA;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_map(&qmap, q, b, nq, hd);
  if (err == cudaSuccess) err = make_map(&kmap, k, b, nk, hd);
  if (err == cudaSuccess) err = make_map(&vmap, v, b, nk, hd);
  if (err != cudaSuccess) return err;
  auto kernel = fused_fwd_tc_kernel<DA>;
  const int smem = Layout<DA>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockRows - 1) / kBlockRows, heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, bias, static_cast<const __nv_bfloat16*>(nullk),
      static_cast<const __nv_bfloat16*>(nullv), null_bias,
      static_cast<__nv_bfloat16*>(out), lse, nq, nk, heads, have_null);
  return cudaGetLastError();
}

}  // namespace

// bf16 operands, head dim 64 or 128, every (b, n, H·d) pointer 16-byte
// aligned.  `bias` may be null (dot product); the null-token pointers may be
// null when have_null is 0.  Returns a cudaError_t.
extern "C" int gigagan_flash_attention_fused_fwd_tc(
    const void* q, const void* k, const void* v, const void* bias,
    const void* nullk, const void* nullv, const void* null_bias, void* out,
    void* lse, int b, int nq, int nk, int heads, int d, int have_null,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || nq <= 0 || nk <= 0 || heads <= 0 ||
      heads > 65535 || (d != 64 && d != 128) ||
      (have_null && (nullk == nullptr || nullv == nullptr ||
                     null_bias == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const float* bf = static_cast<const float*>(bias);
  const float* nbf = static_cast<const float*>(null_bias);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<1>(q, k, v, bf, nullk, nullv, nbf, out, lf, b, nq, nk, heads,
                     have_null, s);
  return launch<2>(q, k, v, bf, nullk, nullv, nbf, out, lf, b, nq, nk, heads,
                   have_null, s);
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
