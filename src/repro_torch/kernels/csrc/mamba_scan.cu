// Mamba-1 selective scan for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (body _scan_kernel). For each batch row b and inner channel d, over time t:
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n]
// with xc (B, L, Di) f32 or bf16, dt (B, L, Di), B/C (B, L, N), A (Di, N) and
// an optional h0 (B, Di, N), all f32. Writes y (B, L, Di) f32 and the final
// h (B, Di, N) f32.
//
// What bounds it on this card: bytes. At the prefill shape of jamba-v0.1-52b
// (B 4, L 512, Di 8192, N 16) it must read xc (bf16) and dt (f32) and write
// y (f32), ~172 MB, against ~2e9 f32 operations.
//
// What the design does:
//   * N lanes of a warp own one (batch, channel) pair: lane n keeps h[n] in a
//     register for the whole sequence, so the (B, L, Di, N) discretised
//     tensors never exist, as in the Pallas kernel.
//   * One loop over all L steps inside the block. The Pallas kernel's chunk
//     grid axis exists only because TPU grid axes run in order; here the loop
//     does the same work, so there is no chunking and no padding: ragged L
//     and ragged Di are bounds checks.
//   * Each lane loads the inputs of U steps before it uses any of them, to
//     keep loads in flight across the dependent recurrence.
//   * y_t is the sum of the N lanes' h[n] * C_t[n], finished with shuffles
//     inside the lane group; one lane writes it.
// expf (not __expf) keeps f32 within 1e-4 of the plain version. This is the
// simple, right first kernel; coalescing dt/x across channels is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // time steps loaded ahead

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_out, int L, int Di) {
  constexpr int CPW = 32 / N;                  // channels per warp
  constexpr int CPB = (THREADS / 32) * CPW;    // channels per block
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = lane % N;
  const int d = blockIdx.x * CPB + warp * CPW + lane / N;
  const bool live = d < Di;  // the same for all N lanes of a group

  const float an = live ? A[(int64_t)d * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? h0[((int64_t)b * Di + d) * N + n] : 0.f;
  const int64_t row0 = (int64_t)b * L;  // index of (b, t = 0) in the (B, L) rows

  for (int t0 = 0; t0 < L; t0 += U) {
    float dtv[U], xv[U], bv[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = row0 + t0 + u;
      const bool in = t0 + u < L;
      dtv[u] = (in && live) ? dt[r * Di + d] : 0.f;
      xv[u] = (in && live) ? to_f(xc[r * Di + d]) : 0.f;
      bv[u] = in ? Bm[r * N + n] : 0.f;
      cv[u] = in ? Cm[r * N + n] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u >= L) break;  // uniform across the block
      h = expf(dtv[u] * an) * h + (dtv[u] * xv[u]) * bv[u];
      float p = h * cv[u];
#pragma unroll
      for (int off = N / 2; off > 0; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (live && n == 0) y[(row0 + t0 + u) * Di + d] = p;
    }
  }
  if (live) h_out[((int64_t)b * Di + d) * N + n] = h;
}

template <typename T, int N>
cudaError_t launch(const void* xc, const float* dt, const float* Bm, const float* Cm,
                   const float* A, const float* h0, float* y, float* h_out, int B, int L,
                   int Di, cudaStream_t stream) {
  constexpr int CPB = (THREADS / 32) * (32 / N);
  dim3 grid((Di + CPB - 1) / CPB, B);
  mamba_scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(xc), dt, Bm, Cm, A, h0, y, h_out, L, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* xc, const float* dt, const float* Bm, const float* Cm,
                       const float* A, const float* h0, float* y, float* h_out, int B, int L,
                       int Di, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, s);
    case 8: return launch<T, 8>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, s);
    case 16: return launch<T, 16>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, s);
    case 32: return launch<T, 32>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of xc): 0 = float32, 1 = bfloat16; h0 may be null (zero state).
// Returns the launch's cudaError_t.
extern "C" int mamba_scan_fwd(const void* xc, const void* dt, const void* Bm, const void* Cm,
                              const void* A, const void* h0, void* y, void* h_out, int dtype,
                              int B, int L, int Di, int N, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const float* f[5] = {static_cast<const float*>(dt), static_cast<const float*>(Bm),
                       static_cast<const float*>(Cm), static_cast<const float*>(A),
                       static_cast<const float*>(h0)};
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_n<float>(xc, f[0], f[1], f[2], f[3], f[4], yo, ho, B, L, Di, N, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(xc, f[0], f[1], f[2], f[3], f[4], yo, ho, B, L, Di,
                                          N, s);
  return (int)cudaErrorInvalidValue;
}
