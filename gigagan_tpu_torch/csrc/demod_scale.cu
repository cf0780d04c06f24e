// Demodulation scale of the sample-adaptive conv, for the calls that need
// no gradient (ops/kernels/demod.py: the sampler's G forward, the d_step's
// fakes).
//
//   d[b,o] = rsqrt(max(eps, Σ_i s[b,i]² · Σ_{n,m} a[b,n]·a[b,m]·G[n,m,i,o]))
//   G[n,m,i,o] = Σ_k W[n,k,i,o]·W[m,k,i,o]
//
// No Pallas kernel precedes it: the JAX package forms the bank Gram and the
// scale as a broadcast multiply-reduce left to XLA
// (gigagan_tpu/ops/adaptive_conv.py:88-102).  The port's differentiable
// form of the same function, a chain of einsums, stays on every call that
// autograd differentiates; on fp32 banks cuBLAS runs its Gram as one
// (2x9)·(9x2) product per (i, o) pair, 262,144 of them at 512 -> 512.
//
// Layouts (fp32 throughout):
//   W        (n, K, ci, co)  the kernel banks, K spatial taps flattened
//   scale_in (b, ci)         1 + the style modulation
//   a        (b, n)          the softmaxed kernel selection; null for n = 1
//   partial  (splits, b, co) the per-split sums (scratch)
//   d        (b, co)
//
// What bounds it on an H100: bytes.  The banks are read once (18.9 MB at
// 2 x 3 x 3 x 512 x 512, 5.6 us at 3.35 TB/s); the Gram costs n²·K FMAs
// per (i, o) and each sample n² + 2 more, a few FMAs per byte read, far
// below the card's 20 fp32 FLOPs per byte.  So the design keeps the Gram
// out of device memory and fills the card with reads: each thread owns one
// output channel o (a warp reads 32 contiguous floats per (n, k, i)) and
// walks input channels i, forming the Gram of its (i, o) in registers and
// adding s²·aᵀGa for each sample of its chunk of 8.  A block is 32 o by 8
// i-rows; the grid is (o tiles, i splits, chunks of 8 samples).  A sample
// chunk past the first re-reads the banks, mostly from L2.
//
// The i-split: one o tile holds too few threads to keep enough reads in
// flight (16 blocks at co = 512, b = 1), so the grid's second axis cuts ci
// into splits, about four blocks per SM in all.  Each block adds its 8
// rows in shared memory in row order and writes one partial sum per
// (b, o) of its split; demod_reduce_kernel adds the splits in index order,
// clamps and takes rsqrt.  No float atomics: a call repeats bitwise.
//
// Any bank count: banks go in tiles of NB (NB = n for n <= 2, else 4); for
// n > 4 the Gram is formed one pair of tiles at a time, an off-diagonal
// pair counted twice.  Any tap count (K = 9 unrolled at compile time), any
// ci, co and b: ragged edges are masked, and chunks past the grid's 65535
// limit are walked by a loop.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;  // output channels per block, one per lane
constexpr int kRows = 8;    // input-channel rows per block
constexpr int kChunk = 8;   // samples per chunk; kChunk == kRows (reduction)
constexpr int kThreads = kLanes * kRows;
constexpr int kReduceThreads = 256;
constexpr int kMaxGridZ = 65535;

static_assert(kChunk == kRows, "a row of the block writes one sample");

// TAPS > 0: the tap count at compile time; 0: `taps` at run time
template <int NB, int TAPS>
__global__ void __launch_bounds__(kThreads)
demod_scale_kernel(const float* __restrict__ w,
                   const float* __restrict__ scale_in,
                   const float* __restrict__ a, float* __restrict__ partial,
                   int b, int n, int taps, int ci, int co, int ci_per_split) {
  __shared__ float coef[kChunk][NB][NB];
  __shared__ float red[kRows][kChunk][kLanes];

  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kLanes + lane;
  const int o = blockIdx.x * kLanes + lane;
  const int split = blockIdx.y;
  const int i_begin = split * ci_per_split;
  const int i_end = min(ci, i_begin + ci_per_split);
  const int k_count = TAPS > 0 ? TAPS : taps;
  const int tiles = (n + NB - 1) / NB;
  const int chunks = (b + kChunk - 1) / kChunk;
  const size_t plane = (size_t)ci * co;  // one tap of one bank

  for (int chunk = blockIdx.z; chunk < chunks; chunk += gridDim.z) {
    const int b0 = chunk * kChunk;
    const int nb = min(kChunk, b - b0);
    float acc[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) acc[s] = 0.f;

    for (int ta = 0; ta < tiles; ++ta) {
      for (int tb = ta; tb < tiles; ++tb) {
        // coef[s][j][l] = a[s, ta·NB+j]·a[s, tb·NB+l], twice off the
        // diagonal; 0 past the banks and the chunk's samples
        __syncthreads();  // the previous pair's readers are done
        for (int idx = tid; idx < kChunk * NB * NB; idx += kThreads) {
          const int s = idx / (NB * NB);
          const int nj = ta * NB + (idx / NB) % NB;
          const int nl = tb * NB + idx % NB;
          float c = 0.f;
          if (s < nb && nj < n && nl < n) {
            c = ta != tb ? 2.f : 1.f;
            if (a != nullptr) {
              const size_t a_s = (size_t)(b0 + s) * n;
              c *= a[a_s + nj] * a[a_s + nl];
            }
          }
          coef[s][(idx / NB) % NB][idx % NB] = c;
        }
        __syncthreads();
        if (o >= co) continue;
        for (int i = i_begin + row; i < i_end; i += kRows) {
          const float* w_i = w + (size_t)i * co + o;
          float g[NB][NB];
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int l = 0; l < NB; ++l) g[j][l] = 0.f;
#pragma unroll 9
          for (int k = 0; k < k_count; ++k) {
            float wa[NB], wb[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int nj = ta * NB + j;
              wa[j] = nj < n ? w_i[((size_t)nj * k_count + k) * plane] : 0.f;
              const int nl = tb * NB + j;
              wb[j] = ta == tb ? wa[j]
                      : (nl < n ? w_i[((size_t)nl * k_count + k) * plane]
                                : 0.f);
            }
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
              for (int l = 0; l < NB; ++l) g[j][l] += wa[j] * wb[l];
          }
#pragma unroll
          for (int s = 0; s < kChunk; ++s) {
            if (s >= nb) break;
            float q = 0.f;
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
              for (int l = 0; l < NB; ++l) q += coef[s][j][l] * g[j][l];
            const float si = scale_in[(size_t)(b0 + s) * ci + i];
            acc[s] += (si * si) * q;
          }
        }
      }
    }

    // the block's 8 rows added in row order; row r then writes sample r
#pragma unroll
    for (int s = 0; s < kChunk; ++s) red[row][s][lane] = acc[s];
    __syncthreads();
    if (row < nb && o < co) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum += red[r][row][lane];
      partial[((size_t)split * b + b0 + row) * co + o] = sum;
    }
    __syncthreads();  // red is written again by the next chunk
  }
}

// d = rsqrt(max(eps, Σ_split partial[split])), the splits added in order
__global__ void __launch_bounds__(kReduceThreads)
demod_reduce_kernel(const float* __restrict__ partial, float* __restrict__ d,
                    int splits, size_t total, float eps) {
  const size_t idx = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  // as torch.clamp(min=eps): a NaN stays NaN
  d[idx] = rsqrtf(sum < eps ? eps : sum);
}

// input channels per split: about four blocks per SM over the grid, at
// least one whole row of input channels per thread
inline int ci_per_split_for(int b, int ci, int co, int sms) {
  const long tiles = (long)((co + kLanes - 1) / kLanes) *
                     ((b + kChunk - 1) / kChunk);
  const long rows = (ci + kRows - 1) / kRows;
  long splits = (4L * sms + tiles - 1) / tiles;
  if (splits > rows) splits = rows;
  if (splits < 1) splits = 1;
  const long rows_per_split = (rows + splits - 1) / splits;
  return (int)(rows_per_split * kRows);
}

template <int NB, int TAPS>
cudaError_t launch(const float* w, const float* s, const float* a,
                   float* partial, int b, int n, int taps, int ci, int co,
                   int ci_per_split, cudaStream_t stream) {
  const int splits = (ci + ci_per_split - 1) / ci_per_split;
  const int chunks = (b + kChunk - 1) / kChunk;
  const dim3 grid((co + kLanes - 1) / kLanes, splits,
                  chunks < kMaxGridZ ? chunks : kMaxGridZ);
  demod_scale_kernel<NB, TAPS><<<grid, dim3(kLanes, kRows), 0, stream>>>(
      w, s, a, partial, b, n, taps, ci, co, ci_per_split);
  return cudaGetLastError();
}

template <int NB>
cudaError_t by_taps(const float* w, const float* s, const float* a,
                    float* partial, int b, int n, int taps, int ci, int co,
                    int ci_per_split, cudaStream_t stream) {
  if (taps == 9) {
    return launch<NB, 9>(w, s, a, partial, b, n, taps, ci, co, ci_per_split,
                         stream);
  }
  return launch<NB, 0>(w, s, a, partial, b, n, taps, ci, co, ci_per_split,
                       stream);
}

}  // namespace

// Input channels each split sums over (a multiple of 8); the call needs
// splits·b·co floats of scratch, splits = ceil(ci / ci_per_split).
// Returns <= 0 on a CUDA error.
extern "C" int gigagan_demod_scale_ci_per_split(int b, int ci, int co,
                                                int device) {
  int sms = 0;
  if (b <= 0 || ci <= 0 || co <= 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return ci_per_split_for(b, ci, co, sms);
}

// Two launches: demod_scale_kernel, then demod_reduce_kernel.  `a` may be
// null only for n = 1.  Returns a cudaError_t.
extern "C" int gigagan_demod_scale(const void* w, const void* scale_in,
                                   const void* a, void* partial, void* d,
                                   int b, int n, int taps, int ci, int co,
                                   int ci_per_split, float eps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long splits = ci_per_split > 0
                          ? (ci + (long)ci_per_split - 1) / ci_per_split
                          : 0;
  if (b <= 0 || n <= 0 || taps <= 0 || ci <= 0 || co <= 0 ||
      ci_per_split <= 0 || ci_per_split % kRows != 0 || splits > 65535 ||
      (a == nullptr && n != 1) || partial == nullptr || d == nullptr) {
    return cudaErrorInvalidValue;
  }
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale_in);
  const float* af = static_cast<const float*>(a);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    err = by_taps<1>(wf, sf, af, pf, b, n, taps, ci, co, ci_per_split, st);
  } else if (n == 2) {
    err = by_taps<2>(wf, sf, af, pf, b, n, taps, ci, co, ci_per_split, st);
  } else {
    err = by_taps<4>(wf, sf, af, pf, b, n, taps, ci, co, ci_per_split, st);
  }
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)b * co;
  const unsigned blocks =
      (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  demod_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      pf, static_cast<float*>(d), (int)splits, total, eps);
  return cudaGetLastError();
}

extern "C" const char* gigagan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
