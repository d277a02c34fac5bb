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
// The design (namespace chunked; mamba_scan_bwd):
//   * A block owns 64 channels of one batch row; each channel's N states are
//     split over P = N / 4 lanes of 4 states (Geo), so a block is 16 N
//     threads and jamba's scan is 4 times the warps of one thread a channel:
//     at ~128 registers a thread, 16 warps an SM (the first design held 6).
//     dx and ddt sum over a channel's lanes by log2 P shuffles.
//   * Loads a chunk at a time (Tiles): a chunk's K = 16 steps of dt, dy and
//     xc, its B_t and C_t and its checkpoint are copied into shared memory by
//     cp.async (4 bytes, any Di; bf16 xc through registers), and the next
//     chunk's copies are issued before this one runs, so no step waits on
//     global memory; B and C are read as broadcasts.
//   * A checkpoint pass (ckpt_ahead_kernel, the same blocks, lanes and
//     tiles) runs the forward recurrence and stores h at the start of every
//     chunk in f32 scratch (B x slots x N x Di, 136 MB at that shape).
//   * The reverse pass (rev_chunk_kernel) walks the chunks backwards: it
//     recomputes a chunk's K + 1 states from its checkpoint into registers
//     (17 x 4 a lane; ptxas spills ~50 bytes at the cap of 128), then runs g
//     back through them. h_t is never recomputed in reverse (h_{t-1} = (h_t -
//     dt x B) / a_t would divide by a decay that may underflow). Sub-chunks
//     of 8 steps recomputed from the checkpoint (half the registers, 1.5
//     times the recompute's exponentials) measured slower and spilled as
//     much.
//   * dB_t and dC_t sum over the channels of (b, t): each warp reduces its
//     lanes' 8 terms over its channels by a reduce-scatter of shuffles (7 at
//     N = 16; channel_sum), the warps' sums meet in shared memory and are
//     added in warp order into one partial a block; a last launch sums the
//     Di/64 partials, and dA's per-batch sums, in a fixed order. No float
//     atomics anywhere: a repeated call is bit-equal.
//   * A scan past the offset limit is cut into the forward's segments:
//     checkpoint passes in order (each seeded with the last one's final
//     state, left in the next checkpoint slot), reverse passes in reverse
//     (each seeded with the later one's g, left in dh0), dA carried in
//     part_a from one to the next, so the result is bit-equal to one
//     segment.
// The first design (namespace bwd; mamba_scan_bwd_per_step: one thread a
// channel, global loads at every step, states in shared memory, per-warp
// partials) is no longer chosen; chip_smoke.py times it beside the chunked
// one.

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

// ---------------------------------------------------------------------------
// the backward's chunked design (K7b): no global load on a step's critical path
// ---------------------------------------------------------------------------
namespace chunked {

constexpr int K = bwd::K;  // steps between checkpoints
constexpr int S = 4;       // states a lane holds
constexpr int CHB = 64;    // channels a block of the reverse pass
constexpr float LOG2E = 1.4426950408889634f;

// Lanes c * P + q of a warp: channel c of the warp's G, states S q .. S q + 3.
template <int N>
struct Geo {
  static constexpr int P = N / S, G = 32 / P, WARPS = CHB / G, THREADS = 32 * WARPS, M = 2 * N;
  // the dB, dC sums over a warp's channels: H halving shuffle steps (lane
  // bits 16, 8, 4 while they are channel bits), then plain butterflies on
  // the channel bits below; a lane ends with R sums, duplicated on the lanes
  // that differ only in PLAIN_MASK's bits
  static_assert(N == 4 || N == 8 || N == 16 || N == 32, "mamba_scan.py's STATE_SIZES");
  static constexpr int H = G >= 8 ? 3 : 2;
  static constexpr int R = 8 >> H;
  static constexpr int PLAIN_MASK = (16 >> H) >= P ? 2 * (16 >> H) - P : 0;
};

// the shared memory of a block: two buffers of a chunk's inputs (dt, dy, B,
// C, its checkpoint, xc), then the warps' dB, dC sums of its K steps
template <typename T_, int N>
struct Smem {
  static constexpr int BUF = (2 * K * CHB + 2 * K * N + N * CHB) * 4 + K * CHB * (int)sizeof(T_);
  static constexpr int RED = K * Geo<N>::WARPS * Geo<N>::M * 4;
  static constexpr int BYTES = 2 * BUF + RED;
  static_assert(BUF % 16 == 0, "buffers 16-byte aligned");
};

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// A block's chunk tiles (channels d0 .. d0 + CHB - 1 of batch row b) in
// buffer i of shared memory: dt, dy, xc [K][CHB], B, C [K][N] and the
// chunk's checkpoint [N][CHB]; steps past L and channels past Di read zeros.
// Copies are cp.async of 4 bytes (any Di), but bf16 xc, which goes through
// registers (xr) to the buffer after the chunk in flight (put_xr).
template <typename T_, int N>
struct Tiles {
  static constexpr int THREADS = Geo<N>::THREADS, XR = K * CHB / THREADS;
  static constexpr bool XC_F32 = sizeof(T_) == 4;
  static_assert(K * CHB % THREADS == 0, "the tiles split evenly");
  uint8_t* sm;
  const T_* xc;
  const float *dt, *dy, *bp, *cp, *ckb;  // dy, cp, ckb: the reverse pass's alone
  int64_t rowb;
  int d0, L, Di, slot0;

  __device__ float* dt_of(int i) const { return reinterpret_cast<float*>(sm + i * Smem<T_, N>::BUF); }
  __device__ float* dy_of(int i) const { return dt_of(i) + K * CHB; }
  __device__ float* b_of(int i) const { return dy_of(i) + K * CHB; }
  __device__ float* c_of(int i) const { return b_of(i) + K * N; }
  __device__ float* ck_of(int i) const { return c_of(i) + K * N; }
  __device__ T_* xc_of(int i) const { return reinterpret_cast<T_*>(ck_of(i) + N * CHB); }

  // issue chunk c's copies into buffer i (REV: also dy, C and the checkpoint)
  template <bool REV>
  __device__ void stage(int i, int c, T_ (&xr)[XC_F32 ? 1 : XR]) const {
    const int t0 = c * K, tid = threadIdx.x;
    float *sdt = dt_of(i), *sdy = dy_of(i);
    T_* sxc = xc_of(i);
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int e = tid + r * THREADS, t = t0 + e / CHB, dd = d0 + e % CHB;
      const bool in = t < L && dd < Di;
      const int64_t off = in ? rowb + (int64_t)t * Di + dd : 0;
      cp_async4(sdt + e, dt + off, in ? 4 : 0);
      if constexpr (REV) cp_async4(sdy + e, dy + off, in ? 4 : 0);
      if constexpr (XC_F32) cp_async4(sxc + e, xc + off, in ? 4 : 0);
      else xr[r] = in ? xc[off] : from_f<T_>(0.f);
    }
    float* sB = b_of(i);  // B's rows, then C's
    for (int e = tid; e < (REV ? 2 : 1) * K * N; e += THREADS) {
      const int j = e % (K * N), t = t0 + j / N;
      const bool in = t < L;
      cp_async4(sB + e, (e < K * N ? bp : cp) + (in ? (int64_t)t * N + j % N : 0), in ? 4 : 0);
    }
    if constexpr (REV) {
      float* sck = ck_of(i);
      for (int e = tid; e < N * CHB; e += THREADS) {  // state n of channel d0 + dd at [n][dd]
        const int n = e / CHB, dd = d0 + e % CHB;
        const bool in = dd < Di;
        cp_async4(sck + e, in ? ckb + ((int64_t)(slot0 + c) * N + n) * Di + dd : ckb, in ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ void put_xr(int i, const T_ (&xr)[XC_F32 ? 1 : XR]) const {
    if constexpr (!XC_F32) {
#pragma unroll
      for (int r = 0; r < XR; ++r) xc_of(i)[threadIdx.x + r * THREADS] = xr[r];
    }
  }
};

// The checkpoint pass of the chunked design: ckpt_kernel's recurrence and
// slots, with the reverse pass's blocks and lanes (a channel's states split
// over P lanes: 4 times the warps of one thread a channel) and its tiles:
// dt, xc and B of the next chunk in flight while this one runs. The steps
// past L of the last chunk read zeros and leave h as it is.
template <typename T_, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS)
ckpt_ahead_kernel(const T_* __restrict__ xc, const float* __restrict__ dt, const float* __restrict__ Bm,
                  const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ ckpt, int slot0,
                  int slots, int from_ckpt, int write_final, int L, int Di, int64_t sx, int64_t sbc) {
  using G_ = Geo<N>;
  extern __shared__ __align__(16) uint8_t sm_raw[];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % G_::P, cc = warp * G_::G + lane / G_::P;
  const int d0 = blockIdx.x * CHB, d = d0 + cc;
  const bool live = d < Di;
  const Tiles<T_, N> tl{sm_raw, xc, dt, nullptr, Bm + b * sbc, nullptr, nullptr, b * sx, d0, L, Di, slot0};
  float* base = ckpt + (int64_t)b * slots * N * Di + (int64_t)S * q * Di + d;  // state S q + i of slot s at (s N + i) Di
  float a2[S], h[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    a2[i] = live ? A[(int64_t)d * N + S * q + i] * LOG2E : 0.f;
    h[i] = !live ? 0.f
                 : from_ckpt ? base[((int64_t)slot0 * N + i) * Di]
                             : (h0 != nullptr ? h0[((int64_t)b * Di + d) * N + S * q + i] : 0.f);
  }
  T_ xr[Tiles<T_, N>::XC_F32 ? 1 : Tiles<T_, N>::XR];
  const int chunks = (L + K - 1) / K;
  tl.template stage<false>(0, 0, xr);
  tl.put_xr(0, xr);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int c = 0; c <= chunks; ++c) {
    if (live && (c < chunks || write_final)) {
      float* slot = base + (int64_t)(slot0 + c) * N * Di;
#pragma unroll
      for (int i = 0; i < S; ++i) slot[(int64_t)i * Di] = h[i];
    }
    if (c == chunks) break;
    const int buf = c & 1;
    if (c + 1 < chunks) tl.template stage<false>(buf ^ 1, c + 1, xr);
    const float* sdt = tl.dt_of(buf);
    const float* sB = tl.b_of(buf);
    const T_* sxc = tl.xc_of(buf);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dv = sdt[k * CHB + cc], bx = dv * to_f(sxc[k * CHB + cc]);
      const float4 bq = *reinterpret_cast<const float4*>(sB + k * N + S * q);
      const float bb[S] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < S; ++i) h[i] = fmaf(ex2_ftz(dv * a2[i]), h[i], bx * bb[i]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (c + 1 < chunks) tl.put_xr(buf ^ 1, xr);
    __syncthreads();  // the next buffer is whole, and this one free again
  }
}

// Sums v[0 .. 8) over the warp's channels (Geo's H and plain steps, in a
// fixed order); v[0 .. R) hold the lane's sums after.
template <int N>
__device__ __forceinline__ void channel_sum(float (&v)[8], int lane) {
  using G_ = Geo<N>;
#pragma unroll
  for (int j = 0; j < G_::H; ++j) {
    const int half = 4 >> j, o = 16 >> j;
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(bwd::FULL, send, o);
    }
  }
#pragma unroll
  for (int o = 16 >> G_::H; o >= G_::P; o >>= 1)
#pragma unroll
    for (int i = 0; i < G_::R; ++i) v[i] += __shfl_xor_sync(bwd::FULL, v[i], o);
}

// The reverse pass of one segment, chunked: rev_kernel's arithmetic and
// arguments, with part_bc holding one partial a block (NB blocks along Di:
// part_bc[b * sp + (t * NB + block) * 2N + q]). A block owns CHB channels,
// each over P lanes of S states; the chunk's tiles (Tiles) are staged in
// shared memory with its checkpoint, the next chunk's copies in flight while
// this one runs, and its states recomputed into registers. Channels past Di
// carry zeros.
template <typename T_, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS, 512 / Geo<N>::THREADS)
rev_chunk_kernel(const T_* __restrict__ xc, const float* __restrict__ dt, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ ckpt,
                 const float* __restrict__ dy, const float* dh_in, T_* __restrict__ dxc, float* __restrict__ ddt,
                 float* __restrict__ part_bc, float* __restrict__ part_a, float* dh_out, int slot0, int slots,
                 int accumulate, int L, int Di, int64_t sx, int64_t sbc, int64_t sp, int NB) {
  using G_ = Geo<N>;
  constexpr int P = G_::P, THREADS = G_::THREADS, M = G_::M, WARPS = G_::WARPS;
  extern __shared__ __align__(16) uint8_t sm_raw[];
  float* red = reinterpret_cast<float*>(sm_raw + 2 * Smem<T_, N>::BUF);  // [K][WARPS][M]
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % P;
  const int cc = warp * G_::G + lane / P;  // this lane's channel in the block
  const int d0 = blockIdx.x * CHB, d = d0 + cc;
  const bool live = d < Di;
  const int64_t rowb = b * sx;
  const Tiles<T_, N> tl{sm_raw, xc, dt, dy, Bm + b * sbc, Cm + b * sbc, ckpt + (int64_t)b * slots * N * Di,
                        rowb, d0, L, Di, slot0};
  const int64_t own = ((int64_t)b * Di + d) * N + S * q;

  float a2[S], carry[S], da[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    a2[i] = live ? A[(int64_t)d * N + S * q + i] * LOG2E : 0.f;
    carry[i] = (live && dh_in != nullptr) ? dh_in[own + i] : 0.f;
    da[i] = (live && accumulate) ? part_a[own + i] : 0.f;
  }
  T_ xr[Tiles<T_, N>::XC_F32 ? 1 : Tiles<T_, N>::XR];
  const int chunks = (L + K - 1) / K;
  tl.template stage<true>((chunks - 1) & 1, chunks - 1, xr);
  tl.put_xr((chunks - 1) & 1, xr);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * K, buf = c & 1;
    if (c > 0) tl.template stage<true>(buf ^ 1, c - 1, xr);  // the next chunk in reverse order, in flight meanwhile
    const float* sdt = tl.dt_of(buf);
    const float* sdy = tl.dy_of(buf);
    const float* sB = tl.b_of(buf);
    const float* sC = tl.c_of(buf);
    const float* sck = tl.ck_of(buf);
    const T_* sxc = tl.xc_of(buf);
    // one step of the forward recurrence on this lane's S states
    auto advance = [&](float (&h)[S], int k) {
      const float dv = sdt[k * CHB + cc], bx = dv * to_f(sxc[k * CHB + cc]);
      const float4 bq = *reinterpret_cast<const float4*>(sB + k * N + S * q);
      const float bb[S] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < S; ++i) h[i] = fmaf(ex2_ftz(dv * a2[i]), h[i], bx * bb[i]);
    };
    float hist[K + 1][S];  // the states h_{t-1} of the chunk's steps, and its last h_t
#pragma unroll
    for (int i = 0; i < S; ++i) hist[0][i] = sck[(S * q + i) * CHB + cc];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < S; ++i) hist[k + 1][i] = hist[k][i];
      advance(hist[k + 1], k);
    }
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int t = t0 + k;
      const float dv = sdt[k * CHB + cc], xv = to_f(sxc[k * CHB + cc]), yv = sdy[k * CHB + cc];
      const float4 bq = *reinterpret_cast<const float4*>(sB + k * N + S * q);
      const float4 cq = *reinterpret_cast<const float4*>(sC + k * N + S * q);
      const float bb[S] = {bq.x, bq.y, bq.z, bq.w}, cn[S] = {cq.x, cq.y, cq.z, cq.w};
      const float dx_ = dv * xv;
      float sxb = 0.f, sdt_ = 0.f, v[8];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float g = fmaf(yv, cn[i], carry[i]);
        const float at = ex2_ftz(dv * a2[i]);
        const float ath = at * hist[k][i];
        sxb = fmaf(g, bb[i], sxb);
        sdt_ = fmaf(g, fmaf(xv, bb[i], a2[i] * bwd::LN2 * ath), sdt_);
        da[i] = fmaf(g * dv, ath, da[i]);
        v[i] = g * dx_;
        v[S + i] = yv * hist[k + 1][i];
        carry[i] = at * g;
      }
#pragma unroll
      for (int o = 1; o < P; o <<= 1) {  // over the channel's lanes
        sxb += __shfl_xor_sync(bwd::FULL, sxb, o);
        sdt_ += __shfl_xor_sync(bwd::FULL, sdt_, o);
      }
      if (q == 0 && live && t < L) {
        dxc[rowb + (int64_t)t * Di + d] = from_f<T_>(dv * sxb);
        ddt[rowb + (int64_t)t * Di + d] = sdt_;
      }
      channel_sum<N>(v, lane);
      if ((lane & G_::PLAIN_MASK) == 0) {
        int idx = 0;  // which of the 8 sums this lane holds first: 4 (lane & 16) + 2 (lane & 8) + (lane & 4)
#pragma unroll
        for (int h = 0; h < G_::H; ++h) idx += ((lane >> (4 - h)) & 1) * (4 >> h);
#pragma unroll
        for (int r = 0; r < G_::R; ++r) {
          const int x = idx + r;  // sums 0 .. 3: dB of states S q + x; 4 .. 7: dC
          red[(k * WARPS + warp) * M + (x >> 2) * N + S * q + (x & 3)] = v[r];
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the next chunk's copies
    __syncthreads();  // ... and every warp's sums of this chunk are in
    for (int i = tid; i < K * M; i += THREADS) {  // one partial a block and step, the warps summed in order
      const int k = i / M, qq = i % M;
      if (t0 + k < L) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red[(k * WARPS + w) * M + qq];
        part_bc[b * sp + ((int64_t)(t0 + k) * NB + blockIdx.x) * M + qq] = sum;
      }
    }
    if (c > 0) tl.put_xr(buf ^ 1, xr);
    __syncthreads();  // red and this buffer are free again; the next buffer is whole
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      dh_out[own + i] = carry[i];
      part_a[own + i] = da[i];
    }
  }
}

template <typename T_, int N>
cudaError_t run(const void* xc_, const float* dt, const float* Bm, const float* Cm, const float* A,
                const float* h0, const float* dy, const float* dh_final, float* ckpt, float* part_bc,
                float* part_a, void* dxc_, float* ddt, float* dB, float* dC, float* dA, float* dh0, int B, int L,
                int Di, int seg, cudaStream_t s) {
  using G_ = Geo<N>;
  constexpr int M = G_::M, SMEM = Smem<T_, N>::BYTES;
  const T_* xc = static_cast<const T_*>(xc_);
  T_* dxc = static_cast<T_*>(dxc_);
  const int NB = (Di + CHB - 1) / CHB;
  const int64_t sx = (int64_t)L * Di, sbc = (int64_t)L * N, sp = (int64_t)L * NB * M;
  const int n_seg = (L + seg - 1) / seg;
  int slots = 1;
  for (int i = 0; i < n_seg; ++i) slots += (min(seg, L - i * seg) + K - 1) / K;
  cudaError_t err =
      cudaFuncSetAttribute(rev_chunk_kernel<T_, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ckpt_ahead_kernel<T_, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int slot0 = 0;
  for (int i = 0; i < n_seg; ++i) {
    const int s0 = i * seg, len = min(seg, L - s0);
    ckpt_ahead_kernel<T_, N><<<dim3(NB, B), G_::THREADS, SMEM, s>>>(
        xc + (int64_t)s0 * Di, dt + (int64_t)s0 * Di, Bm + (int64_t)s0 * N, A, i == 0 ? h0 : nullptr, ckpt, slot0,
        slots, i > 0, i + 1 < n_seg, len, Di, sx, sbc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    slot0 += (len + K - 1) / K;
  }
  for (int i = n_seg - 1; i >= 0; --i) {
    const int s0 = i * seg, len = min(seg, L - s0);
    slot0 -= (len + K - 1) / K;
    const bool last = i + 1 == n_seg;
    rev_chunk_kernel<T_, N><<<dim3(NB, B), G_::THREADS, SMEM, s>>>(
        xc + (int64_t)s0 * Di, dt + (int64_t)s0 * Di, Bm + (int64_t)s0 * N, Cm + (int64_t)s0 * N, A, ckpt,
        dy + (int64_t)s0 * Di, last ? dh_final : dh0, dxc + (int64_t)s0 * Di, ddt + (int64_t)s0 * Di,
        part_bc + (int64_t)s0 * NB * M, part_a, dh0, slot0, slots, !last, len, Di, sx, sbc, sp, NB);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t rows = (int64_t)B * L, n_a = (int64_t)Di * N;
  bwd::reduce_bc_kernel<<<(unsigned)((rows * M + 255) / 256), 256, 0, s>>>(part_bc, dB, dC, rows, NB, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd::reduce_a_kernel<<<(unsigned)((n_a + 255) / 256), 256, 0, s>>>(part_a, dA, B, n_a);
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

}  // namespace chunked

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
// ceil(len / 16), plus 1; part_bc (B, L, ceil(Di / 64), 2N) f32 (one partial
// a block of 64 channels); part_a (B, Di, N) f32. seg: the steps of one
// segment ((seg + 16) * Di < 2^31); the scan is taken in ceil(L / seg)
// segments. Returns the first failing launch's cudaError_t.
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
    return (int)chunked::dispatch_n<float>(N, xc, f(dt), f(Bm), f(Cm), f(A), f(h0), f(dy), f(dh_final), o(ckpt),
                                           o(part_bc), o(part_a), dxc, o(ddt), o(dB), o(dC), o(dA), o(dh0), B, L,
                                           Di, seg, s);
  if (dtype == 1)
    return (int)chunked::dispatch_n<__nv_bfloat16>(N, xc, f(dt), f(Bm), f(Cm), f(A), f(h0), f(dy), f(dh_final),
                                                   o(ckpt), o(part_bc), o(part_a), dxc, o(ddt), o(dB), o(dC), o(dA),
                                                   o(dh0), B, L, Di, seg, s);
  return (int)cudaErrorInvalidValue;
}

// The first design of the backward (per-step loads), kept only as
// the baseline that chip_smoke.py times beside mamba_scan_bwd: the same
// arguments, but part_bc (B, L, ceil(Di / 32), 2N), one partial a warp.
extern "C" int mamba_scan_bwd_per_step(const void* xc, const void* dt, const void* Bm, const void* Cm,
                                       const void* A, const void* h0, const void* dy, const void* dh_final,
                                       void* ckpt, void* part_bc, void* part_a, void* dxc, void* ddt, void* dB,
                                       void* dC, void* dA, void* dh0, int dtype, int B, int L, int Di, int N,
                                       int seg, void* stream) {
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
