// Grouped SwiGLU over MoE capacity bins (moe_gmm) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py::moe_gmm (body
// _gmm_kernel). Per expert e, with x (E, C, D), Wg and Wu (E, D, F) and
// Wd (E, F, D):
//   h[e]   = cast_T( silu(x[e] . Wg[e]) * (x[e] . Wu[e]) )   sums in f32
//   out[e] = cast_T( h[e] . Wd[e] )                            sums in f32
// h is cast to x's dtype exactly where the Pallas kernel casts it. Empty
// capacity rows (zeros) are computed like any other and give zeros.
//
// What bounds it on this card: at the prefill shape of jamba-v0.1-52b
// (E 16, C 320, D 4096, F 14336, bf16) operations: 1.80e12 FLOP against
// 5.7 GB of weights and bins (~315 FLOP per byte, above the H100's ~295
// break-even for bf16 tensor cores). At the decode shape (C 4) bytes: all
// 5.64 GB of expert weights are read to produce 16 x 4 rows.
//
// What the design does: the Pallas kernel keeps a (C-block, D) f32
// accumulator in VMEM across its sequential F grid axis. At D = 4096 that
// does not fit one CUDA block's registers or shared memory, and blocks run
// in no order, so ONE CALL IS TWO CUDA LAUNCHES behind the same C entry:
//   1. a fused gate/up pass: each block computes a tile of x.Wg and x.Wu at
//      once (x tile read once for both), applies SiLU and the product in
//      registers, and writes h (E, C, F) in x's dtype to device memory
//      (scratch the wrapper allocates: 147 MB at the prefill shape);
//   2. a tiled h.Wd pass with f32 accumulation over all of F in one block,
//      so no split-F partial sums and no atomics: the result does not depend
//      on launch order.
// Both passes are one templated tiled product: A and B tiles staged in
// shared memory as f32, each thread holding a TM x TN register tile of sums
// (plain FMA). Two tile shapes: 64 x 128 for capacity bins of more than 8
// rows, and 8 x 128 for decode (C <= 8), where a 64-row tile would spend
// 8x the work on empty rows. This is the simple, right first kernel: no
// tensor cores (mma.sync / wgmma), no TMA, no skipping of empty bins; those
// come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BK = 16;  // depth of one staged k slice

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N), row-major, f32 sums, stored as T.
// GATED: two right-hand sides B0 (gate) and B1 (up), result silu(A.B0) * (A.B1).
template <typename T, int BM, int BN, int TM, int TN, bool GATED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gmm_kernel(const T* __restrict__ A, const T* __restrict__ B0, const T* __restrict__ B1,
           T* __restrict__ out, int M, int N, int K) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int THREADS = (BM / TM) * TX;
  constexpr int NB = GATED ? 2 : 1;
  __shared__ float As[BK][BM + 1];  // transposed A tile; +1 spreads the stores over banks
  __shared__ float Bs[NB][BK][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* Ae = A + (int64_t)e * M * K;
  const T* Be0 = B0 + (int64_t)e * K * N;
  const T* Be1 = GATED ? B1 + (int64_t)e * K * N : nullptr;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads take consecutive addresses of one row (coalesced)
#pragma unroll
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f(Ae[(int64_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      const bool in = gk < K && gn < N;
      const int64_t off = (int64_t)gk * N + gn;
      Bs[0][k][n] = in ? to_f(Be0[off]) : 0.f;
      if (GATED) Bs[NB - 1][k][n] = in ? to_f(Be1[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[b][k][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[b][i][j] = fmaf(av[i], bv[j], acc[b][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;  // consecutive threads, consecutive columns
      if (gn >= N) continue;
      const float r = GATED ? silu(acc[0][i][j]) * acc[NB - 1][i][j] : acc[0][i][j];
      out[((int64_t)e * M + gm) * N + gn] = from_f<T>(r);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN, bool GATED>
cudaError_t launch(const T* A, const T* B0, const T* B1, T* out, int E, int M, int N, int K,
                   cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gmm_kernel<T, BM, BN, TM, TN, GATED><<<grid, THREADS, 0, stream>>>(A, B0, B1, out, M, N, K);
  return cudaGetLastError();
}

template <typename T, int BM, int TM, int TN>
cudaError_t two_passes(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                       void* out, int E, int C, int D, int F, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(h);
  cudaError_t err = launch<T, BM, 128, TM, TN, true>(
      xt, static_cast<const T*>(wg), static_cast<const T*>(wu), ht, E, C, F, D, s);
  if (err != cudaSuccess) return err;
  return launch<T, BM, 128, TM, TN, false>(ht, static_cast<const T*>(wd), nullptr,
                                            static_cast<T*>(out), E, C, D, F, s);
}

template <typename T>
cudaError_t dispatch_c(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                       void* out, int E, int C, int D, int F, cudaStream_t s) {
  if (C <= 8) return two_passes<T, 8, 8, 1>(x, wg, wu, wd, h, out, E, C, D, F, s);  // 128 threads
  return two_passes<T, 64, 4, 8>(x, wg, wu, wd, h, out, E, C, D, F, s);               // 256 threads
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h is (E, C, F) scratch in x's dtype.
// Launches the two passes on `stream`; returns the first non-zero cudaError_t.
extern "C" int moe_gmm_fwd(const void* x, const void* w_gate, const void* w_up,
                           const void* w_down, void* h, void* out, int dtype, int E, int C,
                           int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || (C + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_c<float>(x, w_gate, w_up, w_down, h, out, E, C, D, F, s);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(x, w_gate, w_up, w_down, h, out, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}
