// Flash attention forward (causal / sliding-window / GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel): online-softmax attention of q (B, Lq, H, Dk) against
// k (B, Lk, KVH, Dk) and v (B, Lk, KVH, Dv), positions 0..Lq-1 and 0..Lk-1,
// causal meaning k_pos <= q_pos, scale Dk^-0.5. Output (B, Lq, H, Dv) in q's
// dtype; m, l and acc in f32. Every template is on the pair <DK, DV>: DK = DV
// in {16, 32, 64, 128}, and MLA's (96, 64) (minicpm3: nope 64 + rope 32 for q
// and k, v 64), which the Pallas kernel does not take (the JAX package runs
// that pair through repro/models/attention.py::blocked_attention).
//
// What bounds it on this card: at the serving shapes (prefill of stablelm-1.6b,
// B 4, H 32, Dh 64, 512 queries against a 552-slot cache, bf16) the least
// time is set by bytes (q, o and the 512 live K/V slots, ~34 MB, against
// ~4.3 GFLOP of causal work: ~128 FLOP per byte, under the H100's ~295
// FLOP per byte break-even for bf16 tensor cores).
//
// Both routes share the block mapping:
//   * One thread block per (batch x KV head, q-tile). The tile's rows are the
//     gq query heads of that KV head times bq positions (gq * bq <= ROWS), so
//     each K/V tile is fetched from device memory once per KV head and q-tile,
//     and GQA never replicates K/V.
//   * A loop inside the block walks the KV tiles (the TPU's sequential grid
//     axis); tiles that are dead for every row of the block (causal, window,
//     past Lk) are skipped, boundary tiles are masked per element.
// The caller picks the route (flash_attention.py::_route):
//   * route 1, "mma" (bf16): FlashAttention-2 on mma.sync m16n8k16 (bf16 in,
//     f32 accumulate), 4 warps of 16 rows each. Q fragments are loaded once
//     with ldmatrix and kept in registers; K/V tiles of 64 keys are staged in
//     bf16 by 16-byte cp.async into a double-buffered ring, so the next
//     tile's copy overlaps this tile's math, in a layout that keeps
//     ldmatrix (K) and ldmatrix.trans (V) free of bank conflicts (Tile<W>:
//     swizzled rows where a row is a power of two of 16-byte chunks, a row
//     padded by one chunk at DK 96). S = Q.K^T
//     stays in accumulator fragments; the online softmax works on them (row
//     max and sum across the quad of threads sharing a row, in base 2 with
//     the scale folded in); P is rounded to bf16 pairs -- the reference's
//     p.astype(v.dtype) -- and reused directly as the A operand of P.V,
//     since the m16n8k16 accumulator layout equals the A layout. Masks are
//     evaluated only on boundary tiles. wgmma is not needed here: the shape
//     is bound by bytes, and its 4.3-8.6 GFLOP take ~10-20 us even at half
//     the mma.sync rate.
//   * route 0, "fma" (f32 only): the first port's kernel. Four threads share
//     one query row, each holding a quarter of its head dim (q slice and acc
//     slice in registers); K/V tiles of 32 keys are staged in shared memory
//     and read as broadcasts; plain FMA. f32 stays here because the tensor
//     cores would compute f32 products in TF32, which breaks the reference's
//     f32 parity.
//
// Masking keeps the reference's finite NEG_INF = -2e38: a row that is fully
// masked within one tile takes p = exp(0) there, and a later live tile cancels
// it through corr = exp(m_prev - m_new) = 0; with -inf this would be NaN.
// P is rounded to v's dtype before P.V, as the Pallas kernel does (a no-op in
// f32). Given an lse pointer, both routes also write each row's natural
// log-sum-exp of its scaled, masked scores, m + log(l) in f32 (B, H, Lq):
// the backward (flash_attention_bwd.cu) recomputes P from it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {


constexpr int ROWS = 64;         // query rows per block (must match flash_attention.py)
constexpr int TPR = 4;           // threads per query row
constexpr int THREADS = ROWS * TPR;
constexpr int BK = 32;           // keys per KV tile

// Thread (row r, lane-in-row t) owns head dims d = 16*i + 4*t + e, e < 4, of
// q (i < DK/16) and of acc (i < DV/16): the four threads of a row read one
// contiguous 64-byte run per i.
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                       int Lq, int Lk, int H, int KVH, int bq,
                       int causal, int window, float scale) {
  constexpr int NK = DK / 16, NV = DV / 16;
  __shared__ __align__(16) float Ks[BK][DK];
  __shared__ __align__(16) float Vs[BK][DV];

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int q_lo = blockIdx.y * bq;
  const int q_hi = min(q_lo + bq, Lq) - 1;

  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;
  const int g = r / bq, qi = r % bq;
  const int qpos = q_lo + qi;
  const bool row_ok = (g < gq) && (qpos < Lq);
  const int h = kvh * gq + g;

  float qr[4 * NK], acc[4 * NV];
  const int64_t row = row_ok ? (int64_t)(b * Lq + qpos) * H + h : 0;
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[4 * i + e] = row_ok ? q[row * DK + 16 * i + 4 * t + e] : 0.f;
#pragma unroll
  for (int c = 0; c < 4 * NV; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  // between consecutive keys: KVH * DK elements of k, KVH * DV of v
  const float* kb = k + ((int64_t)b * Lk * KVH + kvh) * DK;
  const float* vb = v + ((int64_t)b * Lk * KVH + kvh) * DV;
  const int nkt = (Lk + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    if (causal && k_lo > q_hi) break;               // every later tile is dead too
    if (window > 0 && k_hi <= q_lo - window) continue;  // below every row's window

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * DK; idx += THREADS) {
      const int j = idx / DK, d = idx % DK;
      Ks[j][d] = k_lo + j < Lk ? kb[(int64_t)(k_lo + j) * KVH * DK + d] : 0.f;
    }
    for (int idx = tid; idx < BK * DV; idx += THREADS) {
      const int j = idx / DV, d = idx % DV;
      Vs[j][d] = k_lo + j < Lk ? vb[(int64_t)(k_lo + j) * KVH * DV + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][16 * i + 4 * t]);
        part = fmaf(qr[4 * i + 0], kk.x, part);
        part = fmaf(qr[4 * i + 1], kk.y, part);
        part = fmaf(qr[4 * i + 2], kk.z, part);
        part = fmaf(qr[4 * i + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k_lo + j;
      bool ok = row_ok && kpos < Lk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? part * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][16 * i + 4 * t]);
        acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[row * DV + 16 * i + 4 * t + e] = acc[4 * i + e] / den;
    if (lse != nullptr && t == 0) lse[((int64_t)b * H + h) * Lq + qpos] = m + logf(den);
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
                   int Lk, int H, int KVH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int gq = H / KVH;
  const int bq = ROWS / gq;  // q positions per block
  dim3 grid(B * KVH, (Lq + bq - 1) / bq);
  flash_attention_kernel<DK, DV><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Lq, Lk, H, KVH, bq, causal, window, scale);
  return cudaGetLastError();
}

// the (Dk, Dv) pairs both routes instantiate: Dk = Dv in {16, 32, 64, 128},
// and (96, 64)
#define FA_DISPATCH(LAUNCH, ...)                                  \
  if (Dk == Dv) switch (Dk) {                                     \
      case 16: return LAUNCH<16, 16>(__VA_ARGS__);                \
      case 32: return LAUNCH<32, 32>(__VA_ARGS__);                \
      case 64: return LAUNCH<64, 64>(__VA_ARGS__);                \
      case 128: return LAUNCH<128, 128>(__VA_ARGS__);             \
      default: return cudaErrorInvalidValue;                      \
    }                                                             \
  if (Dk == 96 && Dv == 64) return LAUNCH<96, 64>(__VA_ARGS__);   \
  return cudaErrorInvalidValue;

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
                        int Lk, int H, int KVH, int Dk, int Dv, int causal, int window, float scale,
                        cudaStream_t s) {
  FA_DISPATCH(launch, q, k, v, o, lse, B, Lq, Lk, H, KVH, causal, window, scale, s)
}


// ---------------------------------------------------------------------------
// route 1: FlashAttention-2 on mma.sync m16n8k16 (bf16)
// ---------------------------------------------------------------------------
namespace mma {

constexpr int WARPS = 4, THREADS = 32 * WARPS;  // 16 rows a warp: ROWS in all
constexpr int BKV = 64;                          // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A [rows][W] bf16 tile in shared memory: STRIDE elements a row, and the
// element offset of 16-byte chunk c of row r. The 8 rows one ldmatrix phase
// reads (same chunk, consecutive rows) must fall in 8 different bank groups.
// Where a row is a power of two of chunks, the chunk index is XORed with bits
// of the row: rows of 256 or 128 bytes take r % 8, rows of 64 bytes (r / 2)
// % 4, rows of 32 bytes (r / 4) % 2. A row of 12 chunks (DK 96) has no such
// swizzle within it (c ^ (r & 7) would reach chunk 15), so it is padded by
// one chunk instead: at 13 chunks (208 bytes, 52 words) a row apart, 8
// consecutive rows start at words 0, 20, 8, 28, 16, 4, 24, 12 (mod 32).
template <int W>
struct Tile {
  static constexpr int NCH = W / 8;
  static constexpr bool POW2 = (NCH & (NCH - 1)) == 0;
  static constexpr int STRIDE = POW2 ? W : W + 8;
  __device__ static __forceinline__ int off(int r, int c) {
    if constexpr (POW2) {
      constexpr int SW = NCH >= 8 ? 8 : NCH;
      constexpr int DIV = NCH >= 8 ? 1 : 8 / NCH;
      return r * W + ((c ^ ((r / DIV) & (SW - 1))) << 3);
    } else {
      return r * STRIDE + (c << 3);
    }
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Lq,
            int Lk, int H, int KVH, int bq, int causal, int window, float scale_log2) {
  using TK = Tile<DK>;           // Q and K tiles
  using TV = Tile<DV>;           // V tiles
  constexpr int NCK = DK / 8;    // 16-byte chunks per q / k row
  constexpr int NCV = DV / 8;    // 16-byte chunks per v row
  constexpr int KS = DK / 16;    // k16 steps of Q.K^T over the head dim
  constexpr int NT = BKV / 8;    // n8 tiles of S over the keys
  constexpr int DT = DV / 8;     // n8 tiles of O over v's head dim
  extern __shared__ __align__(16) __nv_bfloat16 fa_smem[];
  __nv_bfloat16* Qs = fa_smem;                    // [64][DK]
  __nv_bfloat16* Ks = Qs + 64 * TK::STRIDE;       // [2][BKV][DK]
  __nv_bfloat16* Vs = Ks + 2 * BKV * TK::STRIDE;  // [2][BKV][DV]

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int q_lo = blockIdx.y * bq;
  const int q_hi = min(q_lo + bq, Lq) - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Q tile: row r is query head kvh * gq + r / bq at position q_lo + r % bq;
  // rows past gq * bq or Lq are zeros and never stored.
  for (int idx = tid; idx < 64 * NCK; idx += THREADS) {
    const int r = idx / NCK, c = idx % NCK;
    const int g = r / bq, qpos = q_lo + r % bq;
    const bool ok = g < gq && qpos < Lq;
    const int64_t off = ok ? ((int64_t)(b * Lq + qpos) * H + kvh * gq + g) * DK + 8 * c : 0;
    cp_async16(Qs + TK::off(r, c), q + off, ok);
  }

  // the KV tiles some row of the block sees: [kt_begin, kt_end)
  const int nkt = (Lk + BKV - 1) / BKV;
  const int kt_end = causal ? min(nkt, q_hi / BKV + 1) : nkt;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BKV;

  // between consecutive keys: KVH * DK elements of k, KVH * DV of v
  const __nv_bfloat16* kb = k + ((int64_t)b * Lk * KVH + kvh) * DK;
  const __nv_bfloat16* vb = v + ((int64_t)b * Lk * KVH + kvh) * DV;
  auto load_kv = [&](int kt, int buf) {
    const int k_lo = kt * BKV;
    __nv_bfloat16* kd = Ks + buf * BKV * TK::STRIDE;
    __nv_bfloat16* vd = Vs + buf * BKV * TV::STRIDE;
    for (int idx = tid; idx < BKV * NCK; idx += THREADS) {
      const int j = idx / NCK, c = idx % NCK;
      const bool ok = k_lo + j < Lk;  // keys past Lk are zeros: 0 * p stays 0
      cp_async16(kd + TK::off(j, c), kb + (ok ? (int64_t)(k_lo + j) * KVH * DK + 8 * c : 0), ok);
    }
    for (int idx = tid; idx < BKV * NCV; idx += THREADS) {
      const int j = idx / NCV, c = idx % NCV;
      const bool ok = k_lo + j < Lk;
      cp_async16(vd + TV::off(j, c), vb + (ok ? (int64_t)(k_lo + j) * KVH * DV + 8 * c : 0), ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // this thread's two rows: r0 (accumulator values 0, 1) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + lane / 4;
  const int qpos0 = q_lo + r0 % bq, qpos1 = q_lo + (r0 + 8) % bq;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  uint32_t qf[KS][4];

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int t = 0; t < KS; ++t)  // rows warp*16 + {0..7, 8..15}, chunks 2t, 2t + 1
        ldsm_x4(qf[t], Qs + TK::off(warp * 16 + mr + 8 * (mi & 1), 2 * t + (mi >> 1)));
    }
    const __nv_bfloat16* kd = Ks + buf * BKV * TK::STRIDE;
    const __nv_bfloat16* vd = Vs + buf * BKV * TV::STRIDE;

    // S = Q . K^T (16 rows x 64 keys a warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];  // keys 8 (2jp + mi/2) + mr, chunk 2t + mi%2
        ldsm_x4(kf, kd + TK::off(8 * (2 * jp + (mi >> 1)) + mr, 2 * t + (mi & 1)));
        mma_16816(s[2 * jp], qf[t], kf[0], kf[1]);
        mma_16816(s[2 * jp + 1], qf[t], kf[2], kf[3]);
      }

    // scale into base 2; mask per element only on boundary tiles
    const int k_lo = kt * BKV;
    const bool edge = k_lo + BKV > Lk || (causal && k_lo + BKV - 1 > q_lo) ||
                      (window > 0 && k_lo <= q_hi - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k_lo + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < Lk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax on the fragments: the 4 threads of a quad share a row
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = exp2f(m_run[h] - mx);
      m_run[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - mx);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - mx);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l_run[h] = l_run[h] * corr[h] + sum;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P . V, P rounded to bf16 and taken from the S fragments as they are
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]), pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];  // keys 16t + 8 (mi%2) + mr, chunk 2dp + mi/2, transposed
        ldsm_x4_trans(vf, vd + TV::off(16 * t + 8 * (mi & 1) + mr, 2 * dp + (mi >> 1)));
        mma_16816(acc[2 * dp], pa, vf[0], vf[1]);
        mma_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * h;
    const int g = r / bq, qpos = q_lo + r % bq;
    if (g >= gq || qpos >= Lq) continue;
    const float inv = 1.f / fmaxf(l, 1e-37f);
    __nv_bfloat16* orow = o + ((int64_t)(b * Lq + qpos) * H + kvh * gq + g) * DV;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * (lane & 3)) =
          pack_bf16(acc[d][2 * h] * inv, acc[d][2 * h + 1] * inv);
    // natural log-sum-exp of the row's scaled scores: m_run is in base 2
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * H + kvh * gq + g) * Lq + qpos] = m_run[h] * LN2 + logf(fmaxf(l, 1e-37f));
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq, int Lk, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t stream) {
  const int gq = H / KVH;
  const int bq = ROWS / gq;  // q positions per block
  const int smem = ((64 + 2 * BKV) * Tile<DK>::STRIDE + 2 * BKV * Tile<DV>::STRIDE) * 2;
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * KVH, (Lq + bq - 1) / bq);
  attn_kernel<DK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Lq, Lk, H, KVH, bq, causal,
      window, scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq, int Lk,
                        int H, int KVH, int Dk, int Dv, int causal, int window, float scale, cudaStream_t s) {
  FA_DISPATCH(launch, q, k, v, o, lse, B, Lq, Lk, H, KVH, causal, window, scale, s)
}

}  // namespace mma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 fma (f32 only), 1 mma (bf16
// only); the wrapper's _route picks it. (Dk, Dv): Dk = Dv in {16, 32, 64,
// 128}, or (96, 64). lse: null, or (B, H, Lq) f32 that receives each row's
// natural log-sum-exp of its scaled, masked scores (the backward's input,
// flash_attention_bwd.cu), at every pair. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                   int route, int B, int Lq, int Lk, int H, int KVH, int Dk, int Dv, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > ROWS)
    return (int)cudaErrorInvalidValue;
  const int bq = ROWS / (H / KVH);
  if ((int64_t)B * KVH > 2147483647LL || (Lq + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    if (dtype != 1 || (bases & 15)) return (int)cudaErrorInvalidValue;
    return (int)mma::dispatch_dh(q, k, v, o, static_cast<float*>(lse), B, Lq, Lk, H, KVH, Dk, Dv, causal, window,
                                 scale, s);
  }
  if (route != 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_dh(q, k, v, o, static_cast<float*>(lse), B, Lq, Lk, H, KVH, Dk, Dv, causal, window, scale,
                          s);
}
