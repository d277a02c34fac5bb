// Flash attention forward (causal / sliding-window / GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel): online-softmax attention of q (B, Lq, H, Dh) against
// k, v (B, Lk, KVH, Dh), positions 0..Lq-1 and 0..Lk-1, causal meaning
// k_pos <= q_pos. Output in q's dtype; m, l and acc in f32.
//
// What bounds it on this card: at the serving shapes (prefill of stablelm-1.6b,
// B 4, H 32, Dh 64, 512 queries against a 552-slot cache, bf16) the least
// time is set by bytes (q, o and the 512 live K/V slots, ~34 MB, against
// ~4.3 GFLOP of causal work: ~128 FLOP per byte, under the H100's ~295
// FLOP per byte break-even for bf16 tensor cores).
//
// What the design does about it:
//   * One thread block per (batch x KV head, q-tile). The tile's rows are the
//     gq query heads of that KV head times bq positions (gq * bq <= ROWS), so
//     each K/V tile is fetched from device memory once per KV head and q-tile,
//     and GQA never replicates K/V.
//   * A loop inside the block walks the KV tiles (the TPU's sequential grid
//     axis); tiles that are dead for every row of the block (causal, window,
//     past Lk) are skipped, boundary tiles are masked per element.
//   * Scores never leave registers: four threads share one query row, each
//     holding a quarter of its head dim (q slice and acc slice in registers);
//     the row's dot products are finished with two warp shuffles.
//   * K/V tiles are staged in shared memory as f32; all rows of a warp read the
//     same key at once, so the reads are broadcasts without bank conflicts.
// This is the simple, right first kernel: plain FMA math, no tensor cores
// (mma.sync / wgmma) and no asynchronous copies; those come later.
//
// Masking keeps the reference's finite NEG_INF = -2e38: a row that is fully
// masked within one tile takes p = exp(0) there, and a later live tile cancels
// it through corr = exp(m_prev - m_new) = 0; with -inf this would be NaN.
// In bf16, P is rounded to v's dtype before P.V, as the Pallas kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;         // query rows per block (must match flash_attention.py)
constexpr int TPR = 4;           // threads per query row
constexpr int THREADS = ROWS * TPR;
constexpr int BK = 32;           // keys per KV tile

// Thread (row r, lane-in-row t) owns head dims d = 16*i + 4*t + e, i < DH/16,
// e < 4: the four threads of a row read one contiguous 64-byte run per i.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Lq, int Lk, int H, int KVH, int bq,
                       int causal, int window, float scale) {
  constexpr int NI = DH / 16;
  constexpr int ND = DH / TPR;  // dims per thread
  __shared__ __align__(16) float Ks[BK][DH];
  __shared__ __align__(16) float Vs[BK][DH];

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

  float qr[ND], acc[ND];
  const int64_t row_off = row_ok ? ((int64_t)(b * Lq + qpos) * H + h) * DH : 0;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] = row_ok ? to_f(q[row_off + 16 * i + 4 * t + e]) : 0.f;
      acc[4 * i + e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  const int64_t kv_stride = (int64_t)KVH * DH;  // between consecutive keys
  const T* kb = k + ((int64_t)b * Lk * KVH + kvh) * DH;
  const T* vb = v + ((int64_t)b * Lk * KVH + kvh) * DH;
  const int nkt = (Lk + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    if (causal && k_lo > q_hi) break;               // every later tile is dead too
    if (window > 0 && k_hi <= q_lo - window) continue;  // below every row's window

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH, d = idx % DH;
      const bool in = k_lo + j < Lk;
      Ks[j][d] = in ? to_f(kb[(int64_t)(k_lo + j) * kv_stride + d]) : 0.f;
      Vs[j][d] = in ? to_f(vb[(int64_t)(k_lo + j) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
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
    for (int c = 0; c < ND; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = round_as<T>(s[j]);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
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
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[row_off + 16 * i + 4 * t + e] = from_f<T>(acc[4 * i + e] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                   int Lk, int H, int KVH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int gq = H / KVH;
  const int bq = ROWS / gq;  // q positions per block
  dim3 grid(B * KVH, (Lq + bq - 1) / bq);
  flash_attention_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lk, H, KVH, bq, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                        int Lk, int H, int KVH, int Dh, int causal, int window, float scale,
                        cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Lq, Lk, H, KVH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Lq, int Lk, int H, int KVH, int Dh,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > ROWS)
    return (int)cudaErrorInvalidValue;
  const int bq = ROWS / (H / KVH);
  if ((int64_t)B * KVH > 2147483647LL || (Lq + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, o, B, Lq, Lk, H, KVH, Dh, causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, H, KVH, Dh, causal, window,
                                           scale, s);
  return (int)cudaErrorInvalidValue;
}
