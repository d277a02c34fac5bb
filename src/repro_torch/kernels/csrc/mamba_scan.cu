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
//
// THE BACKWARD (mamba_scan_bwd, K7b) has no Pallas counterpart: the JAX train
// step differentiates the chunked associative scan of repro/models/mamba.py
// (selective_scan). With a_t = exp(dt_t A) and g_t the cotangent of h_t,
//   g_t     = C_t dy_t + a_{t+1} g_{t+1}          (seeded with dh_final)
//   dx_t    = dt_t sum_n g_t[n] B_t[n]
//   ddt_t   = sum_n g_t[n] (x_t B_t[n] + A[n] a_t[n] h_{t-1}[n])
//   dA     += g_t dt_t a_t h_{t-1}                 (summed over b and t)
//   dB_t[n] = sum_d g_t[n] dt_t x_t,  dC_t[n] = sum_d dy_t h_t[n]
//   dh0     = a_1 g_1
// What bounds it: bytes and the exponentials, as the forward: at jamba's
// training shape (B 4, L 1024, Di 8192, N 16) it reads xc, dt and dy and
// writes dxc and ddt (~537 MB, 0.16 ms at 3.35 TB/s), and takes each
// exponential three times (checkpoint pass, recompute, reverse).
// What the design does:
//   * One thread per (batch, channel), the N states in registers, as the
//     forward. A checkpoint pass runs the forward recurrence and stores h at
//     the start of every K = 16 steps in f32 scratch (B x L/16 x N x Di,
//     134 MB at that shape), channel-contiguous so a warp writes whole lines.
//   * The reverse pass walks the chunks backwards: it recomputes a chunk's
//     K + 1 states from its checkpoint into shared memory (a column per
//     thread: [k][n][thread], conflict-free; 1024/N threads a block, so
//     every N takes 17 KiW = 68 KiB), then runs g back through them. h_t is
//     never recomputed in reverse (h_{t-1} = (h_t - dt x B) / a_t would
//     divide by a decay that may underflow).
//   * dB_t and dC_t sum over the channels of (b, t): each warp sums its 2N
//     terms by a reduce-scatter of shuffles (31 for 2N = 32: each step
//     halves the values a lane holds) into a per-warp partial; a last launch
//     sums the Di/32 partials, and dA's per-batch sums, in a fixed order.
//     No float atomics anywhere: a repeated call is bit-equal.
//   * A scan past the offset limit is cut into the forward's segments:
//     checkpoint passes in order (each seeded with the last one's final
//     state, left in the next checkpoint slot), reverse passes in reverse
//     (each seeded with the later one's g, left in dh0), dA carried in
//     registers from one to the next, so the result is bit-equal to one
//     segment.

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

// ---------------------------------------------------------------------------
// the backward (K7b)
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int K = 16;         // steps between checkpoints (mamba_scan.py's BWD_CHUNK)
constexpr int CKPT_CH = 128;  // threads a block of the checkpoint pass
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int log2i(int m) { return m <= 1 ? 0 : 1 + log2i(m / 2); }

// Sums v[OFF .. OFF + M) over the warp's 32 lanes (M a power of 2, <= 32) and
// returns in lane l the total of value OFF + (l >> (5 - log2 M)); v is
// clobbered. Each halving step a lane keeps half its values and adds its
// partner's other half, so 2N = 32 values take 31 shuffles, not 160. The
// order of every addition is fixed.
template <int M, int OFF, int SIZE>
__device__ __forceinline__ float warp_sum_scatter(float (&v)[SIZE], int lane) {
  static_assert(M >= 1 && M <= 32 && (M & (M - 1)) == 0 && OFF + M <= SIZE, "a power of 2 up to 32");
  constexpr int LOG = log2i(M);
#pragma unroll
  for (int j = 0; j < LOG; ++j) {
    const int half = (M >> j) / 2, o = 16 >> j;
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[OFF + i] : v[OFF + i + half];
      const float keep = upper ? v[OFF + i + half] : v[OFF + i];
      v[OFF + i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float r = v[OFF];
#pragma unroll
  for (int o = 16 >> LOG; o > 0; o >>= 1) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

// The forward recurrence of one segment of L steps; stores the state at the
// start of each K-step chunk c in slot slot0 + c and, with write_final, the
// final state in slot slot0 + chunks. Slot s of batch row b holds (n, d) at
// ckpt[((b * slots + s) * N + n) * Di + d]. The initial state is slot slot0
// (from_ckpt: the previous segment's final state) or h0 (B, Di, N) or zero.
template <typename T_, int N>
__global__ void __launch_bounds__(CKPT_CH)
ckpt_kernel(const T_* __restrict__ xc, const float* __restrict__ dt, const float* __restrict__ Bm,
            const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ ckpt, int slot0,
            int slots, int from_ckpt, int write_final, int L, int Di, int64_t sx, int64_t sbc) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * CKPT_CH + threadIdx.x;
  if (d >= Di) return;  // no barrier or shuffle follows
  const float* dtp = dt + b * sx + d;
  const T_* xp = xc + b * sx + d;
  const float* bp = Bm + b * sbc;
  float* base = ckpt + (int64_t)b * slots * N * Di + d;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = A[(int64_t)d * N + n] * 1.4426950408889634f;
    h[n] = from_ckpt ? base[((int64_t)slot0 * N + n) * Di]
                     : (h0 != nullptr ? h0[((int64_t)b * Di + d) * N + n] : 0.f);
  }
  const int chunks = (L + K - 1) / K;
  for (int c = 0; c <= chunks; ++c) {
    if (c < chunks || write_final) {
      float* slot = base + (int64_t)(slot0 + c) * N * Di;
#pragma unroll
      for (int n = 0; n < N; ++n) slot[(int64_t)n * Di] = h[n];
    }
    const int t1 = min(L, (c + 1) * K);
    for (int t = c * K; t < t1; ++t) {
      const float dv = dtp[t * Di], bx = dv * to_f(xp[t * Di]);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = fmaf(ex2_ftz(dv * a2[n]), h[n], bx * __ldg(bp + t * N + n));
    }
  }
}

// The reverse pass of one segment of L steps: threads past Di carry zeros
// (every lane takes part in the shuffles). g's carry comes in from dh_in
// (B, Di, N) or is zero, and goes out to dh_out (may alias dh_in: a thread
// reads its own entries first); dA's per-batch sums are carried in part_a
// (B, Di, N) with accumulate. Per-warp partials of dB (n) and dC (N + n) of
// step t: part_bc[b * sp + (t * W + w) * 2N + q].
template <typename T_, int N>
__global__ void __launch_bounds__(1024 / N)
rev_kernel(const T_* __restrict__ xc, const float* __restrict__ dt, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ ckpt,
           const float* __restrict__ dy, const float* dh_in, T_* __restrict__ dxc, float* __restrict__ ddt,
           float* __restrict__ part_bc, float* __restrict__ part_a, float* dh_out, int slot0, int slots,
           int accumulate, int L, int Di, int64_t sx, int64_t sbc, int64_t sp, int W) {
  constexpr int CH = 1024 / N, M = 2 * N;
  extern __shared__ float sH[];  // (K + 1) x N x CH: state k of the chunk, column = thread
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int d = blockIdx.x * CH + tid;
  const int w = d >> 5;  // this lane's warp along Di
  const bool live = d < Di;
  const int64_t row = b * sx + d;
  const float* bp = Bm + b * sbc;
  const float* cp = Cm + b * sbc;
  const float* base = ckpt + (int64_t)b * slots * N * Di + d;
  float* pbase = part_bc + b * sp;
  const int64_t own = ((int64_t)b * Di + d) * N;

  float a2[N], carry[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? A[(int64_t)d * N + n] * 1.4426950408889634f : 0.f;
    carry[n] = (live && dh_in != nullptr) ? dh_in[own + n] : 0.f;
    da[n] = (live && accumulate) ? part_a[own + n] : 0.f;
  }
  const int chunks = (L + K - 1) / K;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, L - t0);
    // recompute the chunk's states h_{t0 - 1} .. h_{t0 + len - 1} into sH
    {
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = live ? base[((int64_t)(slot0 + c) * N + n) * Di] : 0.f;
        sH[n * CH + tid] = h[n];
      }
      for (int k = 0; k < len; ++k) {
        const int t = t0 + k;
        const float dv = live ? dt[row + t * Di] : 0.f;
        const float bx = dv * (live ? to_f(xc[row + t * Di]) : 0.f);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(ex2_ftz(dv * a2[n]), h[n], bx * __ldg(bp + t * N + n));
          sH[((k + 1) * N + n) * CH + tid] = h[n];
        }
      }
    }
    for (int k = len - 1; k >= 0; --k) {
      const int t = t0 + k;
      const float dv = live ? dt[row + t * Di] : 0.f;
      const float xv = live ? to_f(xc[row + t * Di]) : 0.f;
      const float yv = live ? dy[row + t * Di] : 0.f;
      const float dx_ = dv * xv;
      float sxb = 0.f, sdt = 0.f, v[M];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float bn = __ldg(bp + t * N + n), cn = __ldg(cp + t * N + n);
        const float g = fmaf(yv, cn, carry[n]);
        const float hp = sH[(k * N + n) * CH + tid], hc = sH[((k + 1) * N + n) * CH + tid];
        const float at = ex2_ftz(dv * a2[n]);
        const float ath = at * hp;
        sxb = fmaf(g, bn, sxb);
        sdt = fmaf(g, fmaf(xv, bn, a2[n] * LN2 * ath), sdt);
        da[n] = fmaf(g * dv, ath, da[n]);
        v[n] = g * dx_;
        v[N + n] = yv * hc;
        carry[n] = at * g;
      }
      if (live) {
        dxc[row + t * Di] = from_f<T_>(dv * sxb);
        ddt[row + t * Di] = sdt;
      }
      if (w >= W) continue;  // a warp wholly past Di (uniform in the warp): nothing to sum
      float* pb = pbase + ((int64_t)t * W + w) * M;
      if constexpr (M <= 32) {
        const float r = warp_sum_scatter<M, 0>(v, lane);
        if ((lane & (32 / M - 1)) == 0) pb[lane / (32 / M)] = r;
      } else {
        const float r0 = warp_sum_scatter<32, 0>(v, lane);
        const float r1 = warp_sum_scatter<32, 32>(v, lane);
        pb[lane] = r0;
        pb[32 + lane] = r1;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh_out[own + n] = carry[n];
      part_a[own + n] = da[n];
    }
  }
}

// dB[bt, n] and dC[bt, n] (bt = b * L + t): the sums of the W per-warp
// partials, in order; dA[i] = the sum over b of part_a[b][i], in order
__global__ void reduce_bc_kernel(const float* __restrict__ part_bc, float* __restrict__ dB,
                                 float* __restrict__ dC, int64_t rows, int W, int N) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int M = 2 * N;
  if (i >= rows * M) return;
  const int64_t bt = i / M;
  const int q = (int)(i % M);
  const float* p = part_bc + bt * W * M + q;
  float s = 0.f;
  for (int w = 0; w < W; ++w) s += p[(int64_t)w * M];
  (q < N ? dB : dC)[bt * N + q % N] = s;
}

__global__ void reduce_a_kernel(const float* __restrict__ part_a, float* __restrict__ dA, int B, int64_t n_a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_a) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part_a[b * n_a + i];
  dA[i] = s;
}

template <typename T_, int N>
cudaError_t run(const void* xc_, const float* dt, const float* Bm, const float* Cm, const float* A,
                const float* h0, const float* dy, const float* dh_final, float* ckpt, float* part_bc,
                float* part_a, void* dxc_, float* ddt, float* dB, float* dC, float* dA, float* dh0, int B, int L,
                int Di, int seg, cudaStream_t s) {
  constexpr int CH = 1024 / N, M = 2 * N;
  constexpr int SMEM = (K + 1) * N * CH * 4;
  const T_* xc = static_cast<const T_*>(xc_);
  T_* dxc = static_cast<T_*>(dxc_);
  const int W = (Di + 31) / 32;
  const int64_t sx = (int64_t)L * Di, sbc = (int64_t)L * N, sp = (int64_t)L * W * M;
  const int n_seg = (L + seg - 1) / seg;
  int slots = 1;
  for (int i = 0; i < n_seg; ++i) slots += (min(seg, L - i * seg) + K - 1) / K;
  cudaError_t err = cudaFuncSetAttribute(rev_kernel<T_, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  // checkpoint passes, segments in order
  int slot0 = 0;
  for (int i = 0; i < n_seg; ++i) {
    const int s0 = i * seg, len = min(seg, L - s0);
    ckpt_kernel<T_, N><<<dim3((Di + CKPT_CH - 1) / CKPT_CH, B), CKPT_CH, 0, s>>>(
        xc + (int64_t)s0 * Di, dt + (int64_t)s0 * Di, Bm + (int64_t)s0 * N, A, i == 0 ? h0 : nullptr, ckpt, slot0,
        slots, i > 0, i + 1 < n_seg, len, Di, sx, sbc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    slot0 += (len + K - 1) / K;
  }
  // reverse passes, segments in reverse
  for (int i = n_seg - 1; i >= 0; --i) {
    const int s0 = i * seg, len = min(seg, L - s0);
    slot0 -= (len + K - 1) / K;
    const bool last = i + 1 == n_seg;
    rev_kernel<T_, N><<<dim3((Di + CH - 1) / CH, B), CH, SMEM, s>>>(
        xc + (int64_t)s0 * Di, dt + (int64_t)s0 * Di, Bm + (int64_t)s0 * N, Cm + (int64_t)s0 * N, A, ckpt,
        dy + (int64_t)s0 * Di, last ? dh_final : dh0, dxc + (int64_t)s0 * Di, ddt + (int64_t)s0 * Di,
        part_bc + (int64_t)s0 * W * M, part_a, dh0, slot0, slots, !last, len, Di, sx, sbc, sp, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t rows = (int64_t)B * L, n_a = (int64_t)Di * N;
  reduce_bc_kernel<<<(unsigned)((rows * M + 255) / 256), 256, 0, s>>>(part_bc, dB, dC, rows, W, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_a_kernel<<<(unsigned)((n_a + 255) / 256), 256, 0, s>>>(part_a, dA, B, n_a);
  return cudaGetLastError();
}

template <typename T_>
cudaError_t dispatch_n(int N, const void* xc, const float* dt, const float* Bm, const float* Cm, const float* A,
                       const float* h0, const float* dy, const float* dhf, float* ckpt, float* pbc, float* pa,
                       void* dxc, float* ddt, float* dB, float* dC, float* dA, float* dh0, int B, int L, int Di,
                       int seg, cudaStream_t s) {
  switch (N) {
    case 4: return run<T_, 4>(xc, dt, Bm, Cm, A, h0, dy, dhf, ckpt, pbc, pa, dxc, ddt, dB, dC, dA, dh0, B, L, Di, seg, s);
    case 8: return run<T_, 8>(xc, dt, Bm, Cm, A, h0, dy, dhf, ckpt, pbc, pa, dxc, ddt, dB, dC, dA, dh0, B, L, Di, seg, s);
    case 16: return run<T_, 16>(xc, dt, Bm, Cm, A, h0, dy, dhf, ckpt, pbc, pa, dxc, ddt, dB, dC, dA, dh0, B, L, Di, seg, s);
    case 32: return run<T_, 32>(xc, dt, Bm, Cm, A, h0, dy, dhf, ckpt, pbc, pa, dxc, ddt, dB, dC, dA, dh0, B, L, Di, seg, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

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

// The backward of mamba_scan_fwd over the whole (B, L, ...) tensors: dxc (xc's
// dtype), ddt (B, L, Di), dB, dC (B, L, N), dA (Di, N) and dh0 (B, Di, N), all
// f32 but dxc. h0 and dh_final may be null (zero). Scratch from the caller:
// ckpt (B, slots, N, Di) f32 with slots = sum over the segments of
// ceil(len / 16), plus 1; part_bc (B, L, ceil(Di / 32), 2N) f32; part_a
// (B, Di, N) f32. seg: the steps of one segment ((seg + 16) * Di < 2^31);
// the scan is taken in ceil(L / seg) segments. Returns the first failing
// launch's cudaError_t.
extern "C" int mamba_scan_bwd(const void* xc, const void* dt, const void* Bm, const void* Cm, const void* A,
                              const void* h0, const void* dy, const void* dh_final, void* ckpt, void* part_bc,
                              void* part_a, void* dxc, void* ddt, void* dB, void* dC, void* dA, void* dh0,
                              int dtype, int B, int L, int Di, int N, int seg, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || seg <= 0 || B > 65535 || (int64_t)(seg + 2 * U) * Di > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd::dispatch_n<float>(N, xc, f(dt), f(Bm), f(Cm), f(A), f(h0), f(dy), f(dh_final), o(ckpt),
                                       o(part_bc), o(part_a), dxc, o(ddt), o(dB), o(dC), o(dA), o(dh0), B, L, Di,
                                       seg, s);
  if (dtype == 1)
    return (int)bwd::dispatch_n<__nv_bfloat16>(N, xc, f(dt), f(Bm), f(Cm), f(A), f(h0), f(dy), f(dh_final),
                                               o(ckpt), o(part_bc), o(part_a), dxc, o(ddt), o(dB), o(dC), o(dA),
                                               o(dh0), B, L, Di, seg, s);
  return (int)cudaErrorInvalidValue;
}
