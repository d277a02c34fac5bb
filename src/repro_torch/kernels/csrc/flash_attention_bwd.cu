// Flash attention backward (causal / sliding-window / GQA) for sm_90a: K1.
//
// No Pallas kernel precedes it. The JAX train step (repro/dist/step.py:155-157)
// differentiates repro/models/attention.py::blocked_attention (jnp) by autodiff;
// the port runs its forward as the hand-written flash_attention kernel, so the
// gradient is this kernel: dQ, dK and dV of o = softmax(Q K^T * scale + mask) V
// from q, k, v, o, dO and the forward's per-row log-sum-exp lse (B, H, Lq) f32
// (flash_attention.cu writes it). q and k rows hold Dk values, v and o rows
// Dv: Dk = Dv, or MLA's (Dk 96, Dv 64) (minicpm3: nope 64 + rope 32), scale
// Dk^-0.5. GQA is folded as in the forward: dK and dV of a KV head sum over
// its gq query heads. Masks as the forward (causal means k_pos <= q_pos,
// aligned at the top left; a window keeps k_pos > q_pos - window); Lq and Lk
// may differ (an encoder's non-causal self-attention, cross-attention over
// an encoder memory).
//
// FlashAttention-2's backward, recomputing P from lse and never forming an
// (Lq, Lk) matrix in device memory: D = rowsum(dO * O) (B, H, Lq) f32, then
//   dq: one block per (batch x KV head, q-tile) whose rows are the gq query
//      heads of the KV head times bq positions (the forward's mapping). A loop
//      over the K/V tiles a row of the block sees recomputes s = q.k,
//      p = exp(s*scale - lse), dp = dO.v, ds = p (dp - D) and accumulates
//      dQ += ds k.
//   dkdv: one block per (batch x KV head, key tile). A loop over the gq heads
//      and over the query tiles that can see a key of the tile accumulates
//      dV += p dO and dK += ds q. The block owns its keys for every head of
//      the group, so the GQA sum needs no atomics and the result does not
//      depend on the order of blocks: two runs are bit-equal.
// What bounds it on this card: at stablelm-1.6b's training shape (8, 2048,
// 32, 64), causal, bf16, operations: the five products a visible (query, key)
// pair needs are 6 Dk + 4 Dv FLOP (10 Dh), 3.4e11 a call (0.35 ms at 989
// TFLOP/s) against 0.27 GB of inputs and outputs (0.08 ms); two kernels
// recompute S and dP (7 products a pair, a floor of 7/5 of the bound) and
// take two exp2 a pair. Three routes share that mapping; the wrapper
// (_bwd_route) picks one by the dtype and the head dims:
//   * route 2, "wgmma" (bf16, (Dk, Dv) = (64, 64), (128, 128) and (96, 64)):
//     dq then dkdv, each a block of two warpgroups of 64 rows on wgmma, fed
//     by TMA (128-byte swizzle; 4-D maps (D, heads, L, B), so rows past L
//     are zeros and never the next batch's; a row of 128 as two 64-column
//     boxes, and a row of 96 as two as well, the second box half past the
//     row's end, so TMA fills its last 32 columns with zeros: every tile then
//     has the one swizzle and descriptor layout the Dh 64 and 128 kernels
//     use, S's products stop at depth 96 (6 k-steps), and dQ += dS K and dK
//     += dS^T Q run at N = 96 over 1.5 chunks of K or Q read MN-major; a
//     64-column box plus a 32-column one in the 64-byte swizzle would need a
//     second swizzle in every descriptor and map for no fewer bytes moved)
//     through a ring of 3 or 4 stages with full and empty mbarriers. One
//     thread of warpgroup 0 (in dkdv its first warp, which also copies the
//     tile's lse and D rows by cp.async) refills a stage two tiles after the
//     one that used it: a
//     separate producer warp would cap every thread at 168 registers (see
//     the note in namespace wg). S and dP (or S^T and dP^T) come from wgmma
//     m64nNk16 with both operands K-major in shared memory, as two commit
//     groups, so P's exponentials overlap dP's products; P and dS are
//     rounded to bf16 in registers, where the accumulator's layout is the
//     register A operand's, and multiply K, dO or Q read MN-major (the
//     instruction's transpose of B): dQ += dS K, dV += P^T dO (issued before
//     dS is formed, which it overlaps), dK += dS^T Q, by wgmma m64nNk16 (N
//     = Dk for dQ and dK, Dv for dV).
//     Every group is waited for within its tile: ptxas serialises wgmma
//     whose group stays pending across the loop's back edge while other
//     registers of the warpgroup are written (measured: C7513, C7515).
//     dq: Q and dO resident (a (64, gq, bq) box a warpgroup: rows are
//     position-major, the padding rows of gq 5, 6 or 7 zeroed once and never
//     stored), K/V tiles of 64 keys streamed, the q-tiles in reverse order so
//     the longest causal rows start first; its prologue computes D from the
//     resident dO and O and writes it for dkdv, which runs after it on the
//     stream. dkdv: 128 keys resident (64 a warpgroup), (Q, dO) tiles of 96
//     queries (64 at Dk 96 and 32 at Dk 128, for registers) streamed head
//     by head. Masking of diagonal tiles, and of keys past Lk, is a select on
//     P, never a branch around the products (ptxas serialises wgmma on a
//     divergent path).
//   * route 1, "mma" (bf16, Dk = Dv 16 and 32; 64 and 128 when forced):
//     dot_do_o (four threads a row) writes D, then dq and dkdv on mma.sync m16n8k16
//     (bf16 in, f32 accumulate), 4 warps of 16 rows, tiles staged in bf16 by
//     16-byte cp.async into double-buffered, swizzled shared memory, with the
//     forward's fragment layouts (flash_attention.cu); query tiles of 64 in
//     dkdv (32 at Dh 128, for registers).
//   * route 0, "fma" (f32, every pair): dot_do_o, then all arithmetic f32
//     FMA, 4 threads a row (a query row in dq, a key in dkdv) each holding a quarter of the
//     row's vectors in registers; tiles of 32 rows staged in shared memory as
//     f32. The tensor cores would round f32 products to TF32 and break the
//     reference's f32 parity.
// The tensor-core routes round P and dS to bf16 before their products.
//
// A row with no visible key (window > 0 and q_pos >= Lk - 1 + window) has a
// forward output the kernel does not define; the wrapper refuses such shapes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tc.cuh"

namespace {

constexpr int TPR = 4;                 // threads per row: a query row (dq) or a key row (dkdv)
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / TPR;    // 64 query rows per dq block, 64 keys per dkdv block
constexpr int BT = 32;                 // rows of a tile staged in shared memory

// Lane t of a row owns head dims d = 16 i + 4 t + e (i < DH / 16, e < 4): the
// four lanes of a row read one contiguous run of 16 values per i.
template <typename T, int DH>
__device__ __forceinline__ void load_slice(const T* __restrict__ row, int t, bool ok, float* out) {
#pragma unroll
  for (int i = 0; i < DH / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * i + e] = ok ? to_f(row[16 * i + 4 * t + e]) : 0.f;
}

// sum over the four lanes of a row (lanes 4r .. 4r + 3 of a warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d] over d < DV; row n = (b * Lq + q) * H + h
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS)
dot_do_o_kernel(const T* __restrict__ dout, const T* __restrict__ o, float* __restrict__ dvec,
                int64_t n_rows, int Lq, int H) {
  const int64_t n = (int64_t)blockIdx.x * ROWS + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const bool ok = n < n_rows;
  float a[DV / TPR], c[DV / TPR];
  load_slice<T, DV>(dout + (ok ? n * DV : 0), t, ok, a);
  load_slice<T, DV>(o + (ok ? n * DV : 0), t, ok, c);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DV / TPR; ++i) part = fmaf(a[i], c[i], part);
  part = row_sum(part);
  if (ok && t == 0) {
    const int h = (int)(n % H);
    const int64_t bq = n / H;
    const int64_t b = bq / Lq;
    const int qpos = (int)(bq % Lq);
    dvec[(b * H + h) * Lq + qpos] = part;
  }
}

template <typename T, int DV>
cudaError_t launch_dot_do_o(const T* dout, const T* o, float* dvec, int B, int Lq, int H, cudaStream_t s) {
  const int64_t n_rows = (int64_t)B * Lq * H;
  dot_do_o_kernel<T, DV><<<(unsigned)((n_rows + ROWS - 1) / ROWS), THREADS, 0, s>>>(dout, o, dvec, n_rows, Lq, H);
  return cudaGetLastError();
}

// q, k, dq rows hold DK values; v, o, dO rows DV
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
          T* __restrict__ dq, int Lq, int Lk, int H, int KVH, int bq, int causal, int window, float scale) {
  constexpr int NIK = DK / 16, NIV = DV / 16;
  __shared__ __align__(16) float Ks[BT][DK];
  __shared__ __align__(16) float Vs[BT][DV];

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int q_lo = blockIdx.y * bq;
  const int q_hi = min(q_lo + bq, Lq) - 1;
  const int tid = threadIdx.x, r = tid / TPR, t = tid % TPR;
  const int g = r / bq, qpos = q_lo + r % bq;
  const bool row_ok = g < gq && qpos < Lq;
  const int h = kvh * gq + g;
  const int64_t row = row_ok ? ((int64_t)b * Lq + qpos) * H + h : 0;

  float qr[DK / TPR], dor[DV / TPR], acc[DK / TPR];
  load_slice<T, DK>(q + row * DK, t, row_ok, qr);
  load_slice<T, DV>(dout + row * DV, t, row_ok, dor);
#pragma unroll
  for (int c = 0; c < DK / TPR; ++c) acc[c] = 0.f;
  const int64_t stat = row_ok ? ((int64_t)b * H + h) * Lq + qpos : 0;
  const float lse_r = row_ok ? lse[stat] : 0.f;
  const float d_r = row_ok ? dvec[stat] : 0.f;

  const T* kb = k + ((int64_t)b * Lk * KVH + kvh) * DK;
  const T* vb = v + ((int64_t)b * Lk * KVH + kvh) * DV;
  const int nkt = (Lk + BT - 1) / BT;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_lo = kt * BT, k_hi = k_lo + BT - 1;
    if (causal && k_lo > q_hi) break;                   // every later tile is dead too
    if (window > 0 && k_hi <= q_lo - window) continue;  // below every row's window
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BT * DK; idx += THREADS) {
      const int j = idx / DK, d = idx % DK;
      Ks[j][d] = k_lo + j < Lk ? to_f(kb[(int64_t)(k_lo + j) * KVH * DK + d]) : 0.f;
    }
    for (int idx = tid; idx < BT * DV; idx += THREADS) {
      const int j = idx / DV, d = idx % DV;
      Vs[j][d] = k_lo + j < Lk ? to_f(vb[(int64_t)(k_lo + j) * KVH * DV + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NIK; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][16 * i + 4 * t]);
        s = fmaf(qr[4 * i + 0], kk.x, s);
        s = fmaf(qr[4 * i + 1], kk.y, s);
        s = fmaf(qr[4 * i + 2], kk.z, s);
        s = fmaf(qr[4 * i + 3], kk.w, s);
      }
#pragma unroll
      for (int i = 0; i < NIV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][16 * i + 4 * t]);
        dp = fmaf(dor[4 * i + 0], vv.x, dp);
        dp = fmaf(dor[4 * i + 1], vv.y, dp);
        dp = fmaf(dor[4 * i + 2], vv.z, dp);
        dp = fmaf(dor[4 * i + 3], vv.w, dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kpos = k_lo + j;
      const bool ok = row_ok && kpos < Lk && visible(kpos, qpos, causal, window);
      const float p = ok ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - d_r);
#pragma unroll
      for (int i = 0; i < NIK; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][16 * i + 4 * t]);
        acc[4 * i + 0] = fmaf(ds, kk.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(ds, kk.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(ds, kk.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(ds, kk.w, acc[4 * i + 3]);
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NIK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[row * DK + 16 * i + 4 * t + e] = from_f<T>(acc[4 * i + e] * scale);
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
            T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal, int window,
            float scale) {
  constexpr int NIK = DK / 16, NIV = DV / 16;
  __shared__ __align__(16) float Qs[BT][DK];
  __shared__ __align__(16) float Os[BT][DV];  // dO rows
  __shared__ float Ls[BT], Dl[BT];

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int k_lo = blockIdx.y * ROWS;
  const int k_hi = min(k_lo + ROWS, Lk) - 1;
  const int tid = threadIdx.x, r = tid / TPR, t = tid % TPR;
  const int kpos = k_lo + r;
  const bool row_ok = kpos < Lk;
  const int64_t key = row_ok ? ((int64_t)b * Lk + kpos) * KVH + kvh : 0;

  float kr[DK / TPR], vr[DV / TPR], dka[DK / TPR], dva[DV / TPR];
  load_slice<T, DK>(k + key * DK, t, row_ok, kr);
  load_slice<T, DV>(v + key * DV, t, row_ok, vr);
#pragma unroll
  for (int c = 0; c < DK / TPR; ++c) dka[c] = 0.f;
#pragma unroll
  for (int c = 0; c < DV / TPR; ++c) dva[c] = 0.f;

  // the queries that see some key of this tile: [q_begin, q_end)
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? (int)min((int64_t)Lq, (int64_t)k_hi + window) : Lq;

  for (int g = 0; g < gq; ++g) {
    const int h = kvh * gq + g;
    const int64_t stat0 = ((int64_t)b * H + h) * Lq;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BT * DK; idx += THREADS) {
        const int j = idx / DK, d = idx % DK;
        const bool in = q0 + j < q_end;
        Qs[j][d] = in ? to_f(q[(((int64_t)b * Lq + q0 + j) * H + h) * DK + d]) : 0.f;
      }
      for (int idx = tid; idx < BT * DV; idx += THREADS) {
        const int j = idx / DV, d = idx % DV;
        const bool in = q0 + j < q_end;
        Os[j][d] = in ? to_f(dout[(((int64_t)b * Lq + q0 + j) * H + h) * DV + d]) : 0.f;
      }
      if (tid < BT) {
        const bool in = q0 + tid < q_end;
        Ls[tid] = in ? lse[stat0 + q0 + tid] : 0.f;
        Dl[tid] = in ? dvec[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < BT; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < NIK; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[j][16 * i + 4 * t]);
          s = fmaf(qq.x, kr[4 * i + 0], s);
          s = fmaf(qq.y, kr[4 * i + 1], s);
          s = fmaf(qq.z, kr[4 * i + 2], s);
          s = fmaf(qq.w, kr[4 * i + 3], s);
        }
#pragma unroll
        for (int i = 0; i < NIV; ++i) {
          const float4 oo = *reinterpret_cast<const float4*>(&Os[j][16 * i + 4 * t]);
          dp = fmaf(oo.x, vr[4 * i + 0], dp);
          dp = fmaf(oo.y, vr[4 * i + 1], dp);
          dp = fmaf(oo.z, vr[4 * i + 2], dp);
          dp = fmaf(oo.w, vr[4 * i + 3], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int qp = q0 + j;
        const bool ok = row_ok && qp < q_end && visible(kpos, qp, causal, window);
        const float p = ok ? expf(s * scale - Ls[j]) : 0.f;
        const float ds = p * (dp - Dl[j]);
#pragma unroll
        for (int i = 0; i < NIV; ++i) {
          const float4 oo = *reinterpret_cast<const float4*>(&Os[j][16 * i + 4 * t]);
          dva[4 * i + 0] = fmaf(p, oo.x, dva[4 * i + 0]);
          dva[4 * i + 1] = fmaf(p, oo.y, dva[4 * i + 1]);
          dva[4 * i + 2] = fmaf(p, oo.z, dva[4 * i + 2]);
          dva[4 * i + 3] = fmaf(p, oo.w, dva[4 * i + 3]);
        }
#pragma unroll
        for (int i = 0; i < NIK; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[j][16 * i + 4 * t]);
          dka[4 * i + 0] = fmaf(ds, qq.x, dka[4 * i + 0]);
          dka[4 * i + 1] = fmaf(ds, qq.y, dka[4 * i + 1]);
          dka[4 * i + 2] = fmaf(ds, qq.z, dka[4 * i + 2]);
          dka[4 * i + 3] = fmaf(ds, qq.w, dka[4 * i + 3]);
        }
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NIK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[key * DK + 16 * i + 4 * t + e] = from_f<T>(dka[4 * i + e] * scale);
#pragma unroll
    for (int i = 0; i < NIV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[key * DV + 16 * i + 4 * t + e] = from_f<T>(dva[4 * i + e]);
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* dvec_ = static_cast<float*>(dvec);
  cudaError_t err = launch_dot_do_o<T, DV>(do_, static_cast<const T*>(o), dvec_, B, Lq, H, s);
  if (err != cudaSuccess) return err;
  const int bq = ROWS / (H / KVH);  // q positions per dq block
  dq_kernel<T, DK, DV><<<dim3(B * KVH, (Lq + bq - 1) / bq), THREADS, 0, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<T*>(dq), Lq, Lk, H, KVH, bq, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DK, DV><<<dim3(B * KVH, (Lk + ROWS - 1) / ROWS), THREADS, 0, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, KVH, causal, window,
      scale);
  return cudaGetLastError();
}

// the (Dk, Dv) pairs: Dk = Dv in {16, 32, 64, 128}, and MLA's (96, 64)
#define BWD_PAIRS(X) X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(96, 64)

template <typename T>
cudaError_t dispatch_pair(int Dk, int Dv, const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq,
                          int Lk, int H, int KVH, int causal, int window, float scale, cudaStream_t s) {
#define BWD_CASE(DK, DV)                                                                                     \
  if (Dk == DK && Dv == DV)                                                                                  \
    return launch<T, DK, DV>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, \
                             s);
  BWD_PAIRS(BWD_CASE)
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// route 1: mma.sync m16n8k16 (bf16)
// ---------------------------------------------------------------------------
namespace mma {

constexpr int WARPS = 4, THREADS = 32 * WARPS;  // 16 rows a warp: 64 rows a block
constexpr int BKV = 64;                          // keys per tile (dq) / per block (dkdv)
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// the forward's swizzled [rows][DH] bf16 tile layout (flash_attention.cu)
template <int DH>
__device__ __forceinline__ int tile_off(int r, int c) {
  constexpr int NCH = DH / 8;
  constexpr int SW = NCH >= 8 ? 8 : NCH;
  constexpr int DIV = NCH >= 8 ? 1 : 8 / NCH;
  return r * DH + ((c ^ ((r / DIV) & (SW - 1))) << 3);
}

// A fragment (16 x 16, rows = the warp's 16 rows) of a [rows][DH] tile, k-step t
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile, int warp, int t, int mi, int mr) {
  ldsm_x4(f, tile + tile_off<DH>(warp * 16 + mr + 8 * (mi & 1), 2 * t + (mi >> 1)));
}
// B fragments of n-tiles 2 jp and 2 jp + 1 (rows of the tile are the n index), k-step t
template <int DH>
__device__ __forceinline__ void load_b(uint32_t (&f)[4], const bf16* tile, int jp, int t, int mi, int mr) {
  ldsm_x4(f, tile + tile_off<DH>(8 * (2 * jp + (mi >> 1)) + mr, 2 * t + (mi & 1)));
}
// B fragments of head-dim n-tiles 2 dp and 2 dp + 1 (rows of the tile are the k index), k-step t
template <int DH>
__device__ __forceinline__ void load_bt(uint32_t (&f)[4], const bf16* tile, int dp, int t, int mi, int mr) {
  ldsm_x4_trans(f, tile + tile_off<DH>(16 * t + 8 * (mi & 1) + mr, 2 * dp + (mi >> 1)));
}
// the A fragment of the 16 x 16 block t of a 16-row accumulator, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (*x)[4], int t) {
  a[0] = pack_bf16(x[2 * t][0], x[2 * t][1]);
  a[1] = pack_bf16(x[2 * t][2], x[2 * t][3]);
  a[2] = pack_bf16(x[2 * t + 1][0], x[2 * t + 1][1]);
  a[3] = pack_bf16(x[2 * t + 1][2], x[2 * t + 1][3]);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
          bf16* __restrict__ dq, int Lq, int Lk, int H, int KVH, int bq, int causal, int window,
          float scale_log2, float scale) {
  constexpr int NCH = DH / 8, KS = DH / 16, NT = BKV / 8, DT = DH / 8;
  extern __shared__ __align__(16) bf16 bq_smem[];
  bf16* Qs = bq_smem;             // [64][DH]
  bf16* Os = Qs + 64 * DH;        // [64][DH] dO
  bf16* Ks = Os + 64 * DH;        // [2][BKV][DH]
  bf16* Vs = Ks + 2 * BKV * DH;   // [2][BKV][DH]

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int q_lo = blockIdx.y * bq;
  const int q_hi = min(q_lo + bq, Lq) - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // row r: query head kvh * gq + r / bq at position q_lo + r % bq (as the forward)
  for (int idx = tid; idx < 64 * NCH; idx += THREADS) {
    const int r = idx / NCH, c = idx % NCH;
    const int g = r / bq, qpos = q_lo + r % bq;
    const bool ok = g < gq && qpos < Lq;
    const int64_t off = ok ? (((int64_t)b * Lq + qpos) * H + kvh * gq + g) * DH + 8 * c : 0;
    cp_async16(Qs + tile_off<DH>(r, c), q + off, ok);
    cp_async16(Os + tile_off<DH>(r, c), dout + off, ok);
  }
  const int nkt = (Lk + BKV - 1) / BKV;
  const int kt_end = causal ? min(nkt, q_hi / BKV + 1) : nkt;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BKV;
  const int64_t kv_stride = (int64_t)KVH * DH;
  const bf16* kb = k + ((int64_t)b * Lk * KVH + kvh) * DH;
  const bf16* vb = v + ((int64_t)b * Lk * KVH + kvh) * DH;
  auto load_kv = [&](int kt, int buf) {
    const int k_lo = kt * BKV;
    for (int idx = tid; idx < BKV * NCH; idx += THREADS) {
      const int j = idx / NCH, c = idx % NCH;
      const bool ok = k_lo + j < Lk;  // keys past Lk are zeros, and masked
      const int64_t off = ok ? (int64_t)(k_lo + j) * kv_stride + 8 * c : 0;
      cp_async16(Ks + buf * BKV * DH + tile_off<DH>(j, c), kb + off, ok);
      cp_async16(Vs + buf * BKV * DH + tile_off<DH>(j, c), vb + off, ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // this thread's rows r0 (accumulator values 0, 1) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + lane / 4;
  const int mi = lane >> 3, mr = lane & 7;
  float lse2[2], dd[2];
  int qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int g = r / bq, qpos = q_lo + r % bq;
    const bool ok = g < gq && qpos < Lq;
    const int64_t stat = ok ? ((int64_t)b * H + kvh * gq + g) * Lq + qpos : 0;
    lse2[h] = ok ? lse[stat] * LOG2E : 0.f;
    dd[h] = ok ? dvec[stat] : 0.f;
    qrow[h] = qpos;
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kd = Ks + buf * BKV * DH;
    const bf16* vd = Vs + buf * BKV * DH;

    // S = Q K^T and dP = dO V^T (16 rows x 64 keys a warp)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      uint32_t qf[4], of[4];
      load_a<DH>(qf, Qs, warp, t, mi, mr);
      load_a<DH>(of, Os, warp, t, mi, mr);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4], vf[4];
        load_b<DH>(kf, kd, jp, t, mi, mr);
        load_b<DH>(vf, vd, jp, t, mi, mr);
        mma_16816(s[2 * jp], qf, kf[0], kf[1]);
        mma_16816(s[2 * jp + 1], qf, kf[2], kf[3]);
        mma_16816(dp[2 * jp], of, vf[0], vf[1]);
        mma_16816(dp[2 * jp + 1], of, vf[2], vf[3]);
      }
    }
    // P = exp(S scale - lse), 0 where masked (per element on boundary tiles);
    // dS = P (dP - D), kept in s
    const int k_lo = kt * BKV;
    const bool edge = k_lo + BKV > Lk || (causal && k_lo + BKV - 1 > q_lo) ||
                      (window > 0 && k_lo <= q_hi - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(s[j][e] * scale_log2 - lse2[h]);
        if (edge) {
          const int kpos = k_lo + 8 * j + 2 * (lane & 3) + (e & 1);
          p = (kpos < Lk && visible(kpos, qrow[h], causal, window)) ? p : 0.f;
        }
        s[j][e] = p * (dp[j][e] - dd[h]);
      }
    // dQ += dS K: dS rounded to bf16 as the A operand, K transposed as B
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      uint32_t da[4];
      acc_to_a(da, s, t);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t kf[4];
        load_bt<DH>(kf, kd, d2, t, mi, mr);
        mma_16816(acc[2 * d2], da, kf[0], kf[1]);
        mma_16816(acc[2 * d2 + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int g = r / bq, qpos = q_lo + r % bq;
    if (g >= gq || qpos >= Lq) continue;
    bf16* row = dq + (((int64_t)b * Lq + qpos) * H + kvh * gq + g) * DH;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(row + 8 * d + 2 * (lane & 3)) =
          pack_bf16(acc[d][2 * h] * scale, acc[d][2 * h + 1] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal, int window,
            float scale_log2, float scale) {
  constexpr int BQ = DH == 128 ? 32 : 64;  // queries per tile (registers at Dh 128)
  constexpr int NCH = DH / 8, KS = DH / 16, NT = BQ / 8, DT = DH / 8;
  extern __shared__ __align__(16) bf16 bkv_smem[];
  bf16* Ks = bkv_smem;            // [BKV][DH]
  bf16* Vs = Ks + BKV * DH;       // [BKV][DH]
  bf16* Qs = Vs + BKV * DH;       // [2][BQ][DH]
  bf16* Os = Qs + 2 * BQ * DH;    // [2][BQ][DH] dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * DH);  // [2][BQ] lse * log2(e)
  float* Ds = Ls + 2 * BQ;                                 // [2][BQ] D

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int k_lo = blockIdx.y * BKV;
  const int k_hi = min(k_lo + BKV, Lk) - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < BKV * NCH; idx += THREADS) {
    const int j = idx / NCH, c = idx % NCH;
    const bool ok = k_lo + j < Lk;
    const int64_t off = ok ? (((int64_t)b * Lk + k_lo + j) * KVH + kvh) * DH + 8 * c : 0;
    cp_async16(Ks + tile_off<DH>(j, c), k + off, ok);
    cp_async16(Vs + tile_off<DH>(j, c), v + off, ok);
  }
  // the query tiles that see some key of the block, for each of the gq heads
  const int q_begin = causal ? (k_lo / BQ) * BQ : 0;
  const int q_end = window > 0 ? (int)min((int64_t)Lq, (int64_t)k_hi + window) : Lq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_tiles = gq * nqt;
  auto load_q = [&](int i, int buf) {
    const int h = kvh * gq + i / nqt;
    const int q0 = q_begin + (i % nqt) * BQ;
    for (int idx = tid; idx < BQ * NCH; idx += THREADS) {
      const int r = idx / NCH, c = idx % NCH;
      const bool ok = q0 + r < q_end;
      const int64_t off = ok ? (((int64_t)b * Lq + q0 + r) * H + h) * DH + 8 * c : 0;
      cp_async16(Qs + buf * BQ * DH + tile_off<DH>(r, c), q + off, ok);
      cp_async16(Os + buf * BQ * DH + tile_off<DH>(r, c), dout + off, ok);
    }
    for (int idx = tid; idx < BQ; idx += THREADS) {
      const bool ok = q0 + idx < q_end;
      const int64_t stat = ((int64_t)b * H + h) * Lq + q0 + idx;
      Ls[buf * BQ + idx] = ok ? lse[stat] * LOG2E : 0.f;
      Ds[buf * BQ + idx] = ok ? dvec[stat] : 0.f;
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();

  // this thread's keys: r0 (accumulator values 0, 1) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + lane / 4;
  const int mi = lane >> 3, mr = lane & 7;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) load_q(i + 1, buf ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_begin + (i % nqt) * BQ;
    const bf16* qd = Qs + buf * BQ * DH;
    const bf16* od = Os + buf * BQ * DH;
    const float* ls = Ls + buf * BQ;
    const float* ds = Ds + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T (16 keys x BQ queries a warp)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      uint32_t kf[4], vf[4];
      load_a<DH>(kf, Ks, warp, t, mi, mr);
      load_a<DH>(vf, Vs, warp, t, mi, mr);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t qf[4], of[4];
        load_b<DH>(qf, qd, jp, t, mi, mr);
        load_b<DH>(of, od, jp, t, mi, mr);
        mma_16816(s[2 * jp], kf, qf[0], qf[1]);
        mma_16816(s[2 * jp + 1], kf, qf[2], qf[3]);
        mma_16816(dp[2 * jp], vf, of[0], of[1]);
        mma_16816(dp[2 * jp + 1], vf, of[2], of[3]);
      }
    }
    // P^T = exp(S^T scale - lse), 0 where masked; dS^T = P^T (dP^T - D)
    const bool edge = q0 + BQ > q_end || k_lo + BKV > Lk || (causal && q0 < k_lo + BKV - 1) ||
                      (window > 0 && k_lo <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - ls[col]);
        if (edge) {
          const int kpos = k_lo + r0 + 8 * (e >> 1), qpos = q0 + col;
          p = (qpos < q_end && kpos < Lk && visible(kpos, qpos, causal, window)) ? p : 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ds[col]);
      }
    // dV += P^T dO and dK += dS^T Q: P^T, dS^T rounded to bf16 as A, dO, Q transposed as B
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s, t);
      acc_to_a(da, dp, t);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t of[4], qf[4];
        load_bt<DH>(of, od, d2, t, mi, mr);
        load_bt<DH>(qf, qd, d2, t, mi, mr);
        mma_16816(dva[2 * d2], pa, of[0], of[1]);
        mma_16816(dva[2 * d2 + 1], pa, of[2], of[3]);
        mma_16816(dka[2 * d2], da, qf[0], qf[1]);
        mma_16816(dka[2 * d2 + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k_lo + r0 + 8 * h;
    if (kpos >= Lk) continue;
    const int64_t off = (((int64_t)b * Lk + kpos) * KVH + kvh) * DH;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * d + 2 * (lane & 3)) =
          pack_bf16(dka[d][2 * h] * scale, dka[d][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * d + 2 * (lane & 3)) =
          pack_bf16(dva[d][2 * h], dva[d][2 * h + 1]);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t s) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* dvec_ = static_cast<float*>(dvec);
  cudaError_t err = launch_dot_do_o<bf16, DH>(do_, static_cast<const bf16*>(o), dvec_, B, Lq, H, s);
  if (err != cudaSuccess) return err;
  const int bq = 64 / (H / KVH);
  const int dq_smem = (2 * 64 + 4 * BKV) * DH * 2;
  err = cudaFuncSetAttribute(dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<DH><<<dim3(B * KVH, (Lq + bq - 1) / bq), THREADS, dq_smem, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<bf16*>(dq), Lq, Lk, H, KVH, bq, causal, window, scale * LOG2E,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BQ = DH == 128 ? 32 : 64;
  const int kv_smem = (2 * BKV + 4 * BQ) * DH * 2 + 4 * BQ * 4;
  err = cudaFuncSetAttribute(dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<DH><<<dim3(B * KVH, (Lk + BKV - 1) / BKV), THREADS, kv_smem, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Lq, Lk, H, KVH, causal,
      window, scale * LOG2E, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* o, const void* dout,
                        const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                        int KVH, int causal, int window, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// route 2: wgmma fed by TMA (bf16, Dh 64 and 128)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;
// Two warpgroups a block and no producer warp: 256 threads leave two warps
// on each of an SM's four register files, so ptxas may give each thread 255
// registers (dK and dV alone take 128 at Dh 128). A producer warp or
// warpgroup puts a third warp on one of them and caps every thread at 168,
// whatever setmaxnreg grants at run time (ptxas allocates no more in the
// consumers' branch; measured: C7512, no register past R167). One thread of
// warpgroup 0 (dkdv: its first warp) issues the TMA loads instead, refilling
// each stage two tiles after the one that used it.
constexpr int NWG = 2;
constexpr int THREADS = 128 * NWG;
constexpr int LAG = 2;  // a stage is refilled when the tile LAG before the current one has left it
// the warpgroup's index, shuffled from lane 0 so that the compiler knows it
// to be warp-uniform: the tile addresses and wgmma descriptors derived from
// it then stay in uniform registers (threadIdx.x / 128 measured slower)
__device__ __forceinline__ int warpgroup_index() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }
constexpr int TILE = 64;                  // rows a warpgroup owns; keys of dq's K/V tiles
constexpr int CHUNK = TILE * 128;         // one 64-column chunk of a 64-row tile: 64 rows of 128 bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NO_ROW = 1e30f;           // lse * log2(e) of a query row past the range: exp2(s - NO_ROW) = 0

// The tiles of q and k rows hold DK values, those of v, o and dO rows DV;
// each is NC 64-column chunks (the 128-byte swizzle's rows). A Dk 96 row is
// two chunks whose second holds 32 columns and 32 of TMA's zeros (the map's
// row is 96 long): one swizzle and one descriptor for every tile, and no
// product reads the zeros (S's depth stops at 96 columns; dQ and dK are
// 96 wide).
template <int DK, int DV>
struct Plan {
  static constexpr int NCK = (DK + 63) / 64, NCV = DV / 64;
  static constexpr int KT = NCK * CHUNK, VT = NCV * CHUNK;  // 64 rows of q or k; of v, o or dO
  // dkdv streams query tiles of BQ, as long as its registers allow (S^T and
  // dP^T take BQ f32 a thread beside dK's DK and dV's DV), so that each wait
  // covers more products; dq streams K/V tiles of 64 keys (128 measured
  // slower)
  static constexpr int BQ = DK == 128 ? 32 : DK == 96 ? 64 : 96;
  static constexpr int QCHUNK = BQ * 128, QKT = NCK * QCHUNK, QVT = NCV * QCHUNK;
  static constexpr int DQ_STAGES = DK == 128 ? 3 : 4;
  static constexpr int KV_STAGES = 4;
  // dq: Q and dO of both warpgroups resident, a ring of (K, V) tiles
  static constexpr int DQ_SMEM = NWG * (KT + VT) + DQ_STAGES * (KT + VT) + 8 * (2 * DQ_STAGES + 1) + 1024;
  // dkdv: K and V of both warpgroups resident, a ring of (Q, dO) tiles with their lse and D rows
  static constexpr int KV_SMEM =
      NWG * (KT + VT) + KV_STAGES * (QKT + QVT + 2 * BQ * 4) + 8 * (2 * KV_STAGES + 1) + 1024;
  static_assert(DQ_SMEM <= 232448 && KV_SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}
// Descriptors of a tile read K-major (the reduction dim along its rows) and
// MN-major (its rows are the reduction dim, its columns N); `chunk` is the
// distance between its 64-column chunks. An offset of b bytes is b / 16 in
// the address field.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile) { return sw128_desc(tile, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int chunk) { return sw128_desc(tile, chunk, 1024); }
__device__ __forceinline__ uint64_t plus_bytes(uint64_t d, int bytes) { return d + (bytes >> 4); }
// k-step kk (16 columns) of a K-major tile; k-step t (16 rows) of an MN-major one
__device__ __forceinline__ uint64_t kstep(uint64_t d, int kk, int chunk) {
  return plus_bytes(d, (kk / 4) * chunk + (kk % 4) * 32);
}
__device__ __forceinline__ uint64_t mnstep(uint64_t d, int t) { return plus_bytes(d, t * 2048); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = A . B^T (64 x N, f32), A (64 x D) and B (N x D) K-major, as one
// commit group with its own wgmma.fence (a pipeline stage: S's registers can
// be rewritten once its group is waited for while dP's products still run)
template <int D, int N>
__device__ __forceinline__ void product_t(float (&s)[N / 2], uint64_t a, uint64_t b) {
  fence_acc(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t ak = kstep(a, kk, CHUNK), bk = kstep(b, kk, N * 128);
    if constexpr (N == 96) wgmma_m64n96k16_ss<0>(s, ak, bk, kk > 0);
    else if constexpr (N == 64) wgmma_m64n64k16_ss<0>(s, ak, bk, kk > 0);
    else wgmma_m64n32k16_ss<0>(s, ak, bk, kk > 0);
  }
  wgmma_commit();
  fence_acc(s);
}
// acc (64 x N, f32) += A (64 x K, from registers) . B (K x N, MN-major), one
// commit group; N 96 reads its last 32 columns from the first half of B's
// second chunk
template <int N, int K>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2], uint32_t (&a)[K / 16][4], uint64_t b) {
  fence_acc(acc);
  fence_frags(a);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < K / 16; ++t) {
    if constexpr (N == 64) wgmma_m64n64k16_rs<1>(acc, a[t], mnstep(b, t), 1);
    else if constexpr (N == 96) wgmma_m64n96k16_rs<1>(acc, a[t], mnstep(b, t), 1);
    else wgmma_m64n128k16_rs<1>(acc, a[t], mnstep(b, t), 1);
  }
  wgmma_commit();
  fence_acc(acc);
  fence_frags(a);
}
// the A fragment of k-step t (columns 16t .. 16t + 15) of a 64 x N accumulator, rounded to bf16
template <int R>
__device__ __forceinline__ void acc_frag(uint32_t (&a)[4], const float (&x)[R], int t) {
  a[0] = pack_bf16(x[8 * t + 0], x[8 * t + 1]);
  a[1] = pack_bf16(x[8 * t + 2], x[8 * t + 3]);
  a[2] = pack_bf16(x[8 * t + 4], x[8 * t + 5]);
  a[3] = pack_bf16(x[8 * t + 6], x[8 * t + 7]);
}

// dQ and D. One block per (batch x KV head, 2 x bq positions), the q-tiles in
// reverse order (the longest causal rows first). Warpgroup w owns
// 64 rows: positions p_lo = q_lo + w bq .. + bq - 1 of the gq query heads of
// the KV head, row r = (position - p_lo) gq + head (TMA loads a (64, gq, bq)
// box); rows r >= gq bq are padding, zero and never stored.
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(__grid_constant__ const CUtensorMap mQ, __grid_constant__ const CUtensorMap mdO,
          __grid_constant__ const CUtensorMap mK, __grid_constant__ const CUtensorMap mV,
          const bf16* __restrict__ o, const float* __restrict__ lse, float* __restrict__ dvec,
          bf16* __restrict__ dq, int Lq, int Lk, int H, int KVH, int bq, int causal, int window, float scale_log2,
          float scale) {
  using P = Plan<DK, DV>;
  constexpr int STAGES = P::DQ_STAGES, STAGE = P::KT + P::VT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);                   // [NWG] tiles of DK
  uint8_t* Os = Qs + NWG * P::KT;                       // dO, [NWG] tiles of DV
  uint8_t* ring = Os + NWG * P::VT;                     // [STAGES] x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int gq = H / KVH, rows = gq * bq;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * NWG * bq;
  const int q_last = min(q_lo + NWG * bq, Lq) - 1;
  const int nkt = (Lk + TILE - 1) / TILE;
  const int kt_end = causal ? min(nkt, q_last / TILE + 1) : nkt;
  const int kt_begin = (window > 0 && q_lo - window + 1 > 0) ? (q_lo - window + 1) / TILE : 0;
  const int n = kt_end - kt_begin;
  const int wgi = warpgroup_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);  // every thread releases the stage
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rows < TILE) {  // the padding rows of the Q and dO tiles (contiguous chunks), which no TMA box covers
    const int cnt = NWG * (P::NCK + P::NCV) * (TILE - rows) * 8;
    for (int idx = threadIdx.x; idx < cnt; idx += THREADS) {
      const int u = idx % 8, r = rows + idx / 8 % (TILE - rows), c = idx / (8 * (TILE - rows));
      *reinterpret_cast<uint4*>(Qs + c * CHUNK + r * 128 + u * 16) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // K/V tile i (keys (kt_begin + i) 64 ..) into stage i % STAGES; thread 0
  auto load_kv = [&](int i) {
    const int s = i % STAGES, kt = kt_begin + i;
    uint8_t* st = ring + s * STAGE;
    mbar_expect_tx(&full[s], STAGE);
    for (int c = 0; c < P::NCK; ++c) tma_load_4d(st + c * CHUNK, &mK, &full[s], 64 * c, kvh, kt * TILE, b);
    for (int c = 0; c < P::NCV; ++c) tma_load_4d(st + P::KT + c * CHUNK, &mV, &full[s], 64 * c, kvh, kt * TILE, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, NWG * (P::NCK + P::NCV) * rows * 128);
    for (int w = 0; w < NWG; ++w) {
      for (int c = 0; c < P::NCK; ++c)
        tma_load_4d(Qs + w * P::KT + c * CHUNK, &mQ, qbar, 64 * c, kvh * gq, q_lo + w * bq, b);
      for (int c = 0; c < P::NCV; ++c)
        tma_load_4d(Os + w * P::VT + c * CHUNK, &mdO, qbar, 64 * c, kvh * gq, q_lo + w * bq, b);
    }
    for (int i = 0; i < min(n, STAGES); ++i) load_kv(i);
  }
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const uint8_t* q_t = Qs + wgi * P::KT;
  const uint8_t* do_t = Os + wgi * P::VT;
  const int p_lo = q_lo + wgi * bq;
  // this thread's rows r0 (accumulator values 4j, 4j + 1) and r0 + 8 (4j + 2, 4j + 3)
  const int r0 = 16 * warp + lane / 4;
  int qpos[2];
  bool ok[2];
  int64_t row[2], stat[2];
  float lse2[2], dd[2];
  int klast[2];  // the row's last visible key: causal and Lk folded into one bound
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int h = kvh * gq + r % gq;
    qpos[i] = p_lo + r / gq;
    klast[i] = causal ? min(qpos[i], Lk - 1) : Lk - 1;
    ok[i] = r < rows && qpos[i] < Lq;
    row[i] = ok[i] ? ((int64_t)b * Lq + qpos[i]) * H + h : 0;
    stat[i] = ok[i] ? ((int64_t)b * H + h) * Lq + qpos[i] : 0;
    lse2[i] = ok[i] ? lse[stat[i]] * LOG2E : NO_ROW;
  }
  // D = rowsum(dO * O) of the two rows over DV: dO from the tile, O from
  // device memory (loaded before the tile's wait); the four lanes of a row
  // take its 16-byte chunks c = lane % 4 + 4 u in turn
  uint4 ov[2][DV / 32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < DV / 32; ++u)
      ov[i][u] = ok[i] ? __ldg(reinterpret_cast<const uint4*>(o + row[i] * DV + 8 * (lane % 4 + 4 * u)))
                       : make_uint4(0, 0, 0, 0);
  mbar_wait(qbar, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < DV / 32; ++u) {
      const int c = lane % 4 + 4 * u;
      const uint4 gv =
          *reinterpret_cast<const uint4*>(do_t + (c / 8) * CHUNK + r * 128 + (((c % 8) ^ (r % 8)) << 4));
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ov[i][u]);
      const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 af = __bfloat1622float2(a[e]), gf = __bfloat1622float2(g[e]);
        part = fmaf(af.x, gf.x, part);
        part = fmaf(af.y, gf.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dd[i] = part;
    if (ok[i] && lane % 4 == 0) dvec[stat[i]] = part;
  }

  // S and dP are two commit groups, so P's exponentials overlap dP's
  // products; every group is waited for within its tile (ptxas serialises
  // wgmma whose group stays pending across the loop's back edge while
  // other accumulators are written).
  float acc[DK / 2], sv[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  const uint64_t qd = kmajor(q_t), dod = kmajor(do_t), ring_k = kmajor(ring), ring_mn = mnmajor(ring, CHUNK);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    // refill the stage of tile i - LAG (no product is in flight here)
    if (threadIdx.x == 0 && i >= LAG && i - LAG + STAGES < n) {
      mbar_wait(&empty[(i - LAG) % STAGES], ((i - LAG) / STAGES) & 1);
      load_kv(i - LAG + STAGES);
    }
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint64_t kd = plus_bytes(ring_k, s * STAGE);
    product_t<DK, 64>(sv, qd, kd);
    product_t<DV, 64>(dp, dod, plus_bytes(kd, P::KT));
    wgmma_wait<1>();  // S is done
    fence_acc(sv);
    // P = exp2(S scale log2(e) - lse log2(e)), 0 where masked (per element
    // only on tiles that hold a masked pair: causal, window, or keys past Lk,
    // whose K and V rows are TMA's zeros, so that P there is exactly 0 as the
    // plain version's, whatever the row's lse); dS = P (dP - D). The test is
    // one compare against klast: with visible()'s tests and kpos < Lk, dq's
    // launch took 14-29% longer at the training shapes (tools/torch_bwd_probe.py)
    const int k0 = (kt_begin + i) * TILE;
    const bool edge = k0 + TILE > Lk || (causal && k0 + TILE - 1 > p_lo) ||
                      (window > 0 && k0 <= p_lo + bq - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        float p = exp2_approx(sv[4 * j + e] * scale_log2 - lse2[r]);
        if (edge && (kpos > klast[r] || (window > 0 && kpos <= qpos[r] - window))) p = 0.f;
        sv[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) sv[j] *= dp[j] - dd[(j >> 1) & 1];
    // dQ += dS K: dS rounded to bf16 as the register A operand, K MN-major as B
#pragma unroll
    for (int t4 = 0; t4 < 4; ++t4) acc_frag(da[t4], sv, t4);
    product_rs<DK, 64>(acc, da, plus_bytes(ring_mn, s * STAGE));
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags(da);
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    bf16* out = dq + row[i] * DK;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * (lane % 4)) =
          pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// dK and dV. One block per (batch x KV head, 2 x 64 keys); warpgroup w owns
// keys k_lo + 64 w .. + 63 for every query head of the group. The (Q, dO)
// tiles of BQ queries that see a key of the block stream through the ring
// head by head, with their lse and D rows.
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(__grid_constant__ const CUtensorMap mQ, __grid_constant__ const CUtensorMap mdO,
            __grid_constant__ const CUtensorMap mK, __grid_constant__ const CUtensorMap mV,
            const float* __restrict__ lse, const float* __restrict__ dvec, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal, int window, float scale_log2,
            float scale) {
  using P = Plan<DK, DV>;
  constexpr int STAGES = P::KV_STAGES, STAGE = P::QKT + P::QVT, BQ = P::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);                    // [NWG] tiles of DK
  uint8_t* Vs = Ks + NWG * P::KT;                       // [NWG] tiles of DV
  uint8_t* ring = Vs + NWG * P::VT;                     // [STAGES] x (Q tile, dO tile) of BQ rows
  float* Ls = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [STAGES][BQ] lse
  float* Ds = Ls + STAGES * BQ;                                 // [STAGES][BQ] D
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int gq = H / KVH;
  const int k_lo = blockIdx.y * NWG * TILE;
  const int k_hi = min(k_lo + NWG * TILE, Lk) - 1;
  // the queries that see some key of the block: [q_begin, q_end), in tiles, for each head
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? (int)min((int64_t)Lq, (int64_t)k_hi + window) : Lq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_tiles = gq * nqt;
  const int wgi = warpgroup_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);          // warp 0: lse and D rows, then the TMA bytes
      mbar_init(&empty[s], THREADS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // query tile i (head kvh gq + i / nqt, queries q_begin + (i % nqt) BQ ..)
  // into stage i % STAGES, with its lse and D rows (cp.async, which the full
  // barrier waits for; zeros past Lq, where Q and dO are TMA's zeros too, so
  // those queries add exact zeros to dV and dK); warp 0
  auto load_q = [&](int i) {
    const int s = i % STAGES, lane = threadIdx.x % 32;
    const int h = kvh * gq + i / nqt, q0 = q_begin + (i % nqt) * BQ;
    const int64_t stat0 = ((int64_t)b * H + h) * Lq;
    for (int j = lane; j < BQ; j += 32) {
      const uint32_t bytes = q0 + j < Lq ? 4 : 0;
      const int64_t at = stat0 + (bytes ? q0 + j : 0);
      cp_async4(Ls + s * BQ + j, lse + at, bytes);
      cp_async4(Ds + s * BQ + j, dvec + at, bytes);
    }
    mbar_track_cp_async(&full[s]);
    if (lane == 0) {
      mbar_expect_tx(&full[s], STAGE);
      uint8_t* st = ring + s * STAGE;
      for (int c = 0; c < P::NCK; ++c) tma_load_4d(st + c * P::QCHUNK, &mQ, &full[s], 64 * c, h, q0, b);
      for (int c = 0; c < P::NCV; ++c)
        tma_load_4d(st + P::QKT + c * P::QCHUNK, &mdO, &full[s], 64 * c, h, q0, b);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, NWG * (P::KT + P::VT));
      for (int w = 0; w < NWG; ++w) {
        for (int c = 0; c < P::NCK; ++c)
          tma_load_4d(Ks + w * P::KT + c * CHUNK, &mK, kvbar, 64 * c, kvh, k_lo + w * TILE, b);
        for (int c = 0; c < P::NCV; ++c)
          tma_load_4d(Vs + w * P::VT + c * CHUNK, &mV, kvbar, 64 * c, kvh, k_lo + w * TILE, b);
      }
    }
    for (int i = 0; i < min(n_tiles, STAGES); ++i) load_q(i);
  }
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const uint8_t* k_t = Ks + wgi * P::KT;
  const uint8_t* v_t = Vs + wgi * P::VT;
  const int kw = k_lo + wgi * TILE;
  // this thread's keys kw + r0 (accumulator values 4j, 4j + 1) and kw + r0 + 8 (4j + 2, 4j + 3)
  const int r0 = 16 * warp + lane / 4;
  // S^T and dP^T are two commit groups, so P^T's exponentials overlap
  // dP^T's products, and dV's product overlaps dS^T; every group is waited
  // for within its tile.
  float dka[DK / 2], dva[DV / 2], sv[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
  const uint64_t kd = kmajor(k_t), vd = kmajor(v_t), ring_k = kmajor(ring), ring_mn = mnmajor(ring, P::QCHUNK);
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int q0 = q_begin + (i % nqt) * BQ;
    // refill the stage of tile i - LAG (no product is in flight here)
    if (threadIdx.x < 32 && i >= LAG && i - LAG + STAGES < n_tiles) {
      mbar_wait(&empty[(i - LAG) % STAGES], ((i - LAG) / STAGES) & 1);
      load_q(i - LAG + STAGES);
    }
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint64_t qk = plus_bytes(ring_k, s * STAGE);
    product_t<DK, BQ>(sv, kd, qk);
    product_t<DV, BQ>(dp, vd, plus_bytes(qk, P::QKT));
    wgmma_wait<1>();  // S^T is done
    fence_acc(sv);
    // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked; dS^T =
    // P^T (dP^T - D). Keys past Lk give rows that are never stored.
    const float* ls = Ls + s * BQ;
    const float* dl = Ds + s * BQ;
    const bool edge = (causal && kw + TILE - 1 > q0) || (window > 0 && kw <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = exp2_approx(sv[4 * j + e] * scale_log2 - (c ? l2.y : l2.x) * LOG2E);
        if (edge && !visible(kw + r0 + 8 * (e >> 1), q0 + col + c, causal, window)) p = 0.f;
        sv[4 * j + e] = p;
      }
    }
    // dV += P^T dO: P^T rounded to bf16 as the register A operand, dO MN-major
    const uint64_t qd = plus_bytes(ring_mn, s * STAGE);
#pragma unroll
    for (int t4 = 0; t4 < BQ / 16; ++t4) acc_frag(pa[t4], sv, t4);
    product_rs<DV, BQ>(dva, pa, plus_bytes(qd, P::QKT));
    wgmma_wait<1>();  // dP^T is done
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = sv[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
    // dK += dS^T Q: dS^T rounded to bf16 as the register A operand, Q MN-major
#pragma unroll
    for (int t4 = 0; t4 < BQ / 16; ++t4) acc_frag(da[t4], dp, t4);
    product_rs<DK, BQ>(dka, da, qd);
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    fence_frags(pa);
    fence_frags(da);
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw + r0 + 8 * i;
    if (kpos >= Lk) continue;
    const int64_t key = ((int64_t)b * Lk + kpos) * KVH + kvh;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j)
      *reinterpret_cast<uint32_t*>(dk + key * DK + 8 * j + 2 * (lane % 4)) =
          pack_bf16(dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(dv + key * DV + 8 * j + 2 * (lane % 4)) =
          pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t s) {
  using P = Plan<DK, DV>;
  const int gq = H / KVH, bq = TILE / gq;
  // (B, L, heads, D) tensors as 4-D maps (D, heads, L, B): TMA zero-fills
  // the rows past L (and a Dk 96 row's second chunk past its 96 columns) and
  // never reads into the next batch
  const cuuint64_t qdims[4] = {DK, (cuuint64_t)H, (cuuint64_t)Lq, (cuuint64_t)B};
  const cuuint64_t qstr[3] = {DK * 2, (cuuint64_t)H * DK * 2, (cuuint64_t)Lq * H * DK * 2};
  const cuuint64_t odims[4] = {DV, (cuuint64_t)H, (cuuint64_t)Lq, (cuuint64_t)B};
  const cuuint64_t ostr[3] = {DV * 2, (cuuint64_t)H * DV * 2, (cuuint64_t)Lq * H * DV * 2};
  const cuuint64_t kdims[4] = {DK, (cuuint64_t)KVH, (cuuint64_t)Lk, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {DK * 2, (cuuint64_t)KVH * DK * 2, (cuuint64_t)Lk * KVH * DK * 2};
  const cuuint64_t vdims[4] = {DV, (cuuint64_t)KVH, (cuuint64_t)Lk, (cuuint64_t)B};
  const cuuint64_t vstr[3] = {DV * 2, (cuuint64_t)KVH * DV * 2, (cuuint64_t)Lk * KVH * DV * 2};
  const cuuint32_t group_box[4] = {64, (cuuint32_t)gq, (cuuint32_t)bq, 1};  // dq: gq heads x bq positions
  const cuuint32_t q_box[4] = {64, 1, P::BQ, 1};                          // dkdv: one head's BQ queries
  const cuuint32_t kv_box[4] = {64, 1, TILE, 1};                          // one KV head's 64 keys
  CUtensorMap mQg, mdOg, mQ, mdO, mK, mV;
  if (!tma_map_bf16(&mQg, q, 4, qdims, qstr, group_box) || !tma_map_bf16(&mdOg, dout, 4, odims, ostr, group_box) ||
      !tma_map_bf16(&mQ, q, 4, qdims, qstr, q_box) || !tma_map_bf16(&mdO, dout, 4, odims, ostr, q_box) ||
      !tma_map_bf16(&mK, k, 4, kdims, kstr, kv_box) || !tma_map_bf16(&mV, v, 4, vdims, vstr, kv_box))
    return cudaErrorInvalidValue;
  const float* lse_ = static_cast<const float*>(lse);
  float* dvec_ = static_cast<float*>(dvec);
  // dq first: it writes D, which dkdv reads
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::DQ_SMEM);
  if (err != cudaSuccess) return err;
  dq_kernel<DK, DV><<<dim3(B * KVH, (Lq + NWG * bq - 1) / (NWG * bq)), THREADS, P::DQ_SMEM, s>>>(
      mQg, mdOg, mK, mV, static_cast<const bf16*>(o), lse_, dvec_, static_cast<bf16*>(dq), Lq, Lk, H, KVH, bq,
      causal, window, scale * LOG2E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::KV_SMEM);
  if (err != cudaSuccess) return err;
  dkdv_kernel<DK, DV><<<dim3(B * KVH, (Lk + NWG * TILE - 1) / (NWG * TILE)), THREADS, P::KV_SMEM, s>>>(
      mQ, mdO, mK, mV, lse_, dvec_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Lq, Lk, H, KVH, causal, window,
      scale * LOG2E, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_pair(int Dk, int Dv, const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq,
                          int Lk, int H, int KVH, int causal, int window, float scale, cudaStream_t s) {
#define WG_CASE(DK, DV)                                                                                    \
  if (Dk == DK && Dv == DV)                                                                                \
    return launch<DK, DV>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
  WG_CASE(64, 64) WG_CASE(128, 128) WG_CASE(96, 64)
#undef WG_CASE
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike); lse
// (B, H, Lq) f32 from flash_attention_fwd; dvec (B, H, Lq) f32 scratch (D).
// (Dk, Dv): q, k, dq and dk rows hold Dk values, v, o, dO and dv rows Dv;
// Dk = Dv, or MLA's (96, 64). route: 0 fma (f32 only; every pair of
// BWD_PAIRS), 1 mma (bf16 only, Dk = Dv, 16-byte aligned bases), 2 wgmma
// (bf16, (64, 64), (128, 128) or (96, 64), 16-byte aligned bases); the
// wrapper's _bwd_route picks it. Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int dtype, int route,
                                   int B, int Lq, int Lk, int H, int KVH, int Dk, int Dv, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  if (Dk != Dv && !(Dk == 96 && Dv == 64))  // the one unequal pair, MLA's
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (int64_t)Lq >= (int64_t)Lk + window)  // rows with no visible key
    return (int)cudaErrorInvalidValue;
  const int bq = ROWS / (H / KVH);
  if ((int64_t)B * KVH > 2147483647LL || (Lq + bq - 1) / bq > 65535 || (Lk + ROWS - 1) / ROWS > 65535 ||
      ((int64_t)B * Lq * H + ROWS - 1) / ROWS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
                          (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv;
  if (route == 2) {
    if (dtype != 1 || (bases & 15)) return (int)cudaErrorInvalidValue;
    return (int)wg::dispatch_pair(Dk, Dv, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal,
                                  window, scale, s);
  }
  if (route == 1) {
    if (dtype != 1 || (bases & 15) || Dk != Dv) return (int)cudaErrorInvalidValue;
    return (int)mma::dispatch_dh(Dk, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window,
                                 scale, s);
  }
  if (route != 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_pair<float>(Dk, Dv, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal,
                                   window, scale, s);
}
