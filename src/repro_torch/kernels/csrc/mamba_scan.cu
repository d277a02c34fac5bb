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
// What bounds it on this card: the special-function unit, then bytes. At the
// prefill shape of jamba-v0.1-52b (B 4, L 512, Di 8192, N 16) it must read xc
// (bf16) and dt (f32) and write y (f32), ~172 MB (0.052 ms at 3.35 TB/s), and
// take B * L * Di * N = 2.7e8 exponentials, which sm_90 retires at 16 a clock
// per SM (~0.064 ms at 1980 MHz); ~2e9 f32 operations are below both.
//
// What the design does:
//   * One thread per (batch, channel), with all N states h[n] and A[d, n] in
//     its registers, so the (B, L, Di, N) discretised tensors never exist, as
//     in the Pallas kernel. Consecutive threads own consecutive channels: a
//     warp's reads of dt and xc and its writes of y are whole 128-byte lines
//     a step, and y_t is a sum inside the thread, with no shuffles.
//   * B_t and C_t are the same for every thread of a batch row: a block (one
//     batch row, CH channels) stages them in shared memory, T steps at a
//     time, double-buffered with cp.async, and reads them as broadcasts.
//   * Each thread loads dt and xc for the next U steps while it computes the
//     current U, to keep bytes in flight across the recurrence; the N
//     exponentials of a step are independent, so they fill the pipelines.
//     A step past L reads dt = x = 0 and zero B, which leaves h as it is, so
//     the steps carry no branch (a branch a step cut the compiler's schedule
//     to one step: 0.23 ms against 0.19 without).
//   * exp(dt * A) is exp2(dt * A * log2(e)) by ex2.approx.ftz, one MUFU.EX2
//     each, with A's factor taken once per thread; within 1e-4 of the plain
//     version over L (a result below 2^-126 flushes to 0, as it would round).
//   * One loop over all L steps inside the block. The Pallas kernel's chunk
//     grid axis exists only because TPU grid axes run in order; ragged L,
//     ragged Di and every N in {4, 8, 16, 32} are bounds checks, not padding.
//   * Step offsets t * Di are 32-bit, so one launch takes (L + 16) * Di < 2^31.
//     A longer scan is cut by the wrapper into segments of L steps, each a
//     launch seeded with the last one's h; batch strides (sx, sbc) let a
//     segment be read and written in place inside the whole tensors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CH = 128;  // channels (threads) per block
constexpr int T = 32;    // steps of B and C staged per chunk
constexpr int U = 8;     // steps of dt and xc loaded ahead, per thread
static_assert(T % U == 0, "the staged chunk holds whole load groups");

// 16 bytes from global to shared memory; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T_, int N>
__global__ void __launch_bounds__(CH)
mamba_scan_kernel(const T_* __restrict__ xc, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_out, int L, int Di,
                  int64_t sx, int64_t sbc) {
  __shared__ __align__(16) float sB[2][T][N];
  __shared__ __align__(16) float sC[2][T][N];
  constexpr int PIECES = T * N / 4;  // 16-byte pieces of one tensor's chunk

  const int b = blockIdx.y;
  const int d = blockIdx.x * CH + threadIdx.x;
  const bool live = d < Di;
  // this thread's column at t = 0; step t is t * Di further ((L + 2U) * Di < 2^31,
  // checked). Batch row b starts sx (xc, dt, y) and sbc (B, C) elements on.
  const float* dtp = dt + b * sx + d;
  const T_* xp = xc + b * sx + d;
  float* yp = y + b * sx + d;
  const float* bp = Bm + b * sbc;
  const float* cp = Cm + b * sbc;

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? A[(int64_t)d * N + n] * 1.4426950408889634f : 0.f;  // exp(x) = exp2(x log2 e)
    h[n] = (live && h0 != nullptr) ? h0[((int64_t)b * Di + d) * N + n] : 0.f;
  }

  // stage steps [t0, t0 + T) of B and C; rows past L are zeros
  auto stage = [&](int buf, int t0) {
    const int rows = min(T, L - t0);
    for (int i = threadIdx.x; i < 2 * PIECES; i += CH) {
      const int piece = i % PIECES;
      const bool in = piece / (N / 4) < rows;
      const float* src = (i < PIECES ? bp : cp) + (int64_t)t0 * N + (in ? piece * 4 : 0);
      float* dst = (i < PIECES ? &sB[buf][0][0] : &sC[buf][0][0]) + piece * 4;
      cp_async16(dst, src, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // dt and xc of steps [t0, t0 + U); zeros past L, where a step leaves h as
  // it is: exp2(0 * A) = 1 and dt * x = 0
  auto load = [&](float (&dv)[U], float (&xv)[U], int t0) {
    int off = t0 * Di;
#pragma unroll
    for (int u = 0; u < U; ++u, off += Di) {
      const bool in = live && t0 + u < L;
      dv[u] = in ? dtp[off] : 0.f;
      xv[u] = in ? to_f(xp[off]) : 0.f;
    }
  };

  float dn[U], xn[U];
  stage(0, 0);
  load(dn, xn, 0);
  for (int c = 0; c * T < L; ++c) {
    const int t0 = c * T, buf = c & 1;
    if (t0 + T < L) {
      stage(buf ^ 1, t0 + T);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this chunk's copies are in
    __syncthreads();
    for (int s = 0; s < T && t0 + s < L; s += U) {
      float dv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dv[u] = dn[u];
        xv[u] = xn[u];
      }
      load(dn, xn, t0 + s + U);
#pragma unroll
      for (int u = 0; u < U; ++u) {  // no branch: steps past L change nothing
        const float bx = dv[u] * xv[u];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // 4 sums: a short dependent chain
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 bq = *reinterpret_cast<const float4*>(&sB[buf][s + u][n]);
          const float4 cq = *reinterpret_cast<const float4*>(&sC[buf][s + u][n]);
          const float bb[4] = {bq.x, bq.y, bq.z, bq.w}, cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h[n + i] = fmaf(ex2_ftz(dv[u] * a2[n + i]), h[n + i], bx * bb[i]);
            acc[i] = fmaf(h[n + i], cc[i], acc[i]);
          }
        }
        if (live && t0 + s + u < L) yp[(t0 + s + u) * Di] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((int64_t)b * Di + d) * N + n] = h[n];
  }
}

template <typename T_, int N>
cudaError_t launch(const void* xc, const float* dt, const float* Bm, const float* Cm,
                   const float* A, const float* h0, float* y, float* h_out, int B, int L,
                   int Di, int64_t sx, int64_t sbc, cudaStream_t stream) {
  dim3 grid((Di + CH - 1) / CH, B);
  mamba_scan_kernel<T_, N><<<grid, CH, 0, stream>>>(
      static_cast<const T_*>(xc), dt, Bm, Cm, A, h0, y, h_out, L, Di, sx, sbc);
  return cudaGetLastError();
}

template <typename T_>
cudaError_t dispatch_n(const void* xc, const float* dt, const float* Bm, const float* Cm,
                       const float* A, const float* h0, float* y, float* h_out, int B, int L,
                       int Di, int N, int64_t sx, int64_t sbc, cudaStream_t s) {
  switch (N) {
    case 4: return launch<T_, 4>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, sx, sbc, s);
    case 8: return launch<T_, 8>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, sx, sbc, s);
    case 16: return launch<T_, 16>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, sx, sbc, s);
    case 32: return launch<T_, 32>(xc, dt, Bm, Cm, A, h0, y, h_out, B, L, Di, sx, sbc, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of xc): 0 = float32, 1 = bfloat16; h0 may be null (zero state). Bm and
// Cm must be 16-byte aligned (cp.async). L steps from the given pointers; batch
// row b of xc, dt and y starts sx elements after row b - 1, of Bm and Cm sbc
// (L * Di and L * N for whole tensors; the full length's for a segment of L
// steps inside them, which the caller scans in turn, h_out seeding the next).
// Returns the launch's cudaError_t.
extern "C" int mamba_scan_fwd(const void* xc, const void* dt, const void* Bm, const void* Cm,
                              const void* A, const void* h0, void* y, void* h_out, int dtype,
                              int B, int L, int Di, int N, long long sx, long long sbc,
                              void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || B > 65535 || sx < (long long)L * Di || sbc < (long long)L * N)
    return (int)cudaErrorInvalidValue;
  if (sbc % 4) return (int)cudaErrorMisalignedAddress;  // every row of B and C 16-byte aligned
  if ((int64_t)(L + 2 * U) * Di > 2147483647LL) return (int)cudaErrorInvalidValue;  // 32-bit step offsets
  if (reinterpret_cast<uintptr_t>(Bm) % 16 || reinterpret_cast<uintptr_t>(Cm) % 16)
    return (int)cudaErrorMisalignedAddress;
  const float* f[5] = {static_cast<const float*>(dt), static_cast<const float*>(Bm),
                       static_cast<const float*>(Cm), static_cast<const float*>(A),
                       static_cast<const float*>(h0)};
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_n<float>(xc, f[0], f[1], f[2], f[3], f[4], yo, ho, B, L, Di, N, sx,
                                  sbc, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(xc, f[0], f[1], f[2], f[3], f[4], yo, ho, B, L, Di,
                                          N, sx, sbc, s);
  return (int)cudaErrorInvalidValue;
}
