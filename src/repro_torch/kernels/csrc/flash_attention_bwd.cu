// Flash attention backward (causal / sliding-window / GQA) for sm_90a: K1.
//
// No Pallas kernel precedes it. The JAX train step (repro/dist/step.py:155-157)
// differentiates repro/models/attention.py::blocked_attention (jnp) by autodiff;
// the port runs its forward as the hand-written flash_attention kernel, so the
// gradient is this kernel: dQ, dK and dV of o = softmax(Q K^T * scale + mask) V
// from q, k, v, o, dO and the forward's per-row log-sum-exp lse (B, H, Lq) f32
// (flash_attention.cu writes it). GQA is folded as in the forward: dK and dV of
// a KV head sum over its gq query heads. Masks as the forward (causal means
// k_pos <= q_pos, aligned at the top left; a window keeps k_pos > q_pos - window).
//
// FlashAttention-2's backward, recomputing P from lse and never forming an
// (Lq, Lk) matrix in device memory, in three launches on the caller's stream:
//   1. dot_do_o: D = rowsum(dO * O) (B, H, Lq) f32, four threads a row.
//   2. dq: one block per (batch x KV head, q-tile) with the forward's block
//      mapping (64 rows: the gq query heads of the KV head times bq
//      positions). A loop over the K/V tiles a row of the block sees
//      recomputes s = q.k, p = exp(s*scale - lse), dp = dO.v,
//      ds = p (dp - D) and accumulates dQ += ds k.
//   3. dkdv: one block per (batch x KV head, 64-key tile). A loop over the gq
//      heads and over the query tiles that can see a key of the tile
//      accumulates dV += p dO and dK += ds q. The block owns its keys for
//      every head of the group, so the GQA sum needs no atomics and the
//      result does not depend on the order of blocks: two runs are
//      bit-equal.
// Two routes share that mapping; the wrapper (_route) picks one by the dtype,
// as for the forward:
//   * route 0, "fma" (f32): all arithmetic f32 FMA, 4 threads a row (a query
//     row in dq, a key in dkdv) each holding a quarter of the row's vectors
//     in registers; tiles of 32 rows staged in shared memory as f32. The
//     tensor cores would round f32 products to TF32 and break the
//     reference's f32 parity. 7 Dh-long products a (query, key) pair (s and
//     dp twice, dQ, dK, dV) bound it by the f32 FMA rate.
//   * route 1, "mma" (bf16): mma.sync m16n8k16 (bf16 in, f32 accumulate), 4
//     warps of 16 rows, tiles staged in bf16 by 16-byte cp.async into
//     double-buffered, swizzled shared memory, with the forward's fragment
//     layouts (flash_attention.cu): S and dP stay in accumulator fragments;
//     P and dS are rounded to bf16 and reused as the A operand of the next
//     product, as FlashAttention-2 does. dq: S = Q K^T, dP = dO V^T,
//     dQ += dS K over 64-key tiles. dkdv: S^T = K Q^T, dP^T = V dO^T,
//     dV += P^T dO, dK += dS^T Q over query tiles of 64 (32 at Dh 128, for
//     registers). Speed with wgmma and TMA is later work.
//
// A row with no visible key (window > 0 and q_pos >= Lk - 1 + window) has a
// forward output the kernel does not define; the wrapper refuses such shapes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
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

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d]; row n = (b * Lq + q) * H + h
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dot_do_o_kernel(const T* __restrict__ dout, const T* __restrict__ o, float* __restrict__ dvec,
                int64_t n_rows, int Lq, int H) {
  const int64_t n = (int64_t)blockIdx.x * ROWS + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const bool ok = n < n_rows;
  float a[DH / TPR], c[DH / TPR];
  load_slice<T, DH>(dout + (ok ? n * DH : 0), t, ok, a);
  load_slice<T, DH>(o + (ok ? n * DH : 0), t, ok, c);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DH / TPR; ++i) part = fmaf(a[i], c[i], part);
  part = row_sum(part);
  if (ok && t == 0) {
    const int h = (int)(n % H);
    const int64_t bq = n / H;
    const int64_t b = bq / Lq;
    const int qpos = (int)(bq % Lq);
    dvec[(b * H + h) * Lq + qpos] = part;
  }
}

template <typename T, int DH>
cudaError_t launch_dot_do_o(const T* dout, const T* o, float* dvec, int B, int Lq, int H, cudaStream_t s) {
  const int64_t n_rows = (int64_t)B * Lq * H;
  dot_do_o_kernel<T, DH><<<(unsigned)((n_rows + ROWS - 1) / ROWS), THREADS, 0, s>>>(dout, o, dvec, n_rows, Lq, H);
  return cudaGetLastError();
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
          T* __restrict__ dq, int Lq, int Lk, int H, int KVH, int bq, int causal, int window, float scale) {
  constexpr int NI = DH / 16, ND = DH / TPR;
  __shared__ __align__(16) float Ks[BT][DH];
  __shared__ __align__(16) float Vs[BT][DH];

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int q_lo = blockIdx.y * bq;
  const int q_hi = min(q_lo + bq, Lq) - 1;
  const int tid = threadIdx.x, r = tid / TPR, t = tid % TPR;
  const int g = r / bq, qpos = q_lo + r % bq;
  const bool row_ok = g < gq && qpos < Lq;
  const int h = kvh * gq + g;
  const int64_t row_off = row_ok ? (((int64_t)b * Lq + qpos) * H + h) * DH : 0;

  float qr[ND], dor[ND], acc[ND];
  load_slice<T, DH>(q + row_off, t, row_ok, qr);
  load_slice<T, DH>(dout + row_off, t, row_ok, dor);
#pragma unroll
  for (int c = 0; c < ND; ++c) acc[c] = 0.f;
  const int64_t stat = row_ok ? ((int64_t)b * H + h) * Lq + qpos : 0;
  const float lse_r = row_ok ? lse[stat] : 0.f;
  const float d_r = row_ok ? dvec[stat] : 0.f;

  const int64_t kv_stride = (int64_t)KVH * DH;  // between consecutive keys
  const T* kb = k + ((int64_t)b * Lk * KVH + kvh) * DH;
  const T* vb = v + ((int64_t)b * Lk * KVH + kvh) * DH;
  const int nkt = (Lk + BT - 1) / BT;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_lo = kt * BT, k_hi = k_lo + BT - 1;
    if (causal && k_lo > q_hi) break;                   // every later tile is dead too
    if (window > 0 && k_hi <= q_lo - window) continue;  // below every row's window
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BT * DH; idx += THREADS) {
      const int j = idx / DH, d = idx % DH;
      const bool in = k_lo + j < Lk;
      Ks[j][d] = in ? to_f(kb[(int64_t)(k_lo + j) * kv_stride + d]) : 0.f;
      Vs[j][d] = in ? to_f(vb[(int64_t)(k_lo + j) * kv_stride + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][16 * i + 4 * t]);
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][16 * i + 4 * t]);
        s = fmaf(qr[4 * i + 0], kk.x, s);
        s = fmaf(qr[4 * i + 1], kk.y, s);
        s = fmaf(qr[4 * i + 2], kk.z, s);
        s = fmaf(qr[4 * i + 3], kk.w, s);
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
      for (int i = 0; i < NI; ++i) {
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
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[row_off + 16 * i + 4 * t + e] = from_f<T>(acc[4 * i + e] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
            T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal, int window,
            float scale) {
  constexpr int NI = DH / 16, ND = DH / TPR;
  __shared__ __align__(16) float Qs[BT][DH];
  __shared__ __align__(16) float Os[BT][DH];  // dO rows
  __shared__ float Ls[BT], Dl[BT];

  const int bh = blockIdx.x;  // b * KVH + kvh
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int k_lo = blockIdx.y * ROWS;
  const int k_hi = min(k_lo + ROWS, Lk) - 1;
  const int tid = threadIdx.x, r = tid / TPR, t = tid % TPR;
  const int kpos = k_lo + r;
  const bool row_ok = kpos < Lk;
  const int64_t key_off = row_ok ? (((int64_t)b * Lk + kpos) * KVH + kvh) * DH : 0;

  float kr[ND], vr[ND], dka[ND], dva[ND];
  load_slice<T, DH>(k + key_off, t, row_ok, kr);
  load_slice<T, DH>(v + key_off, t, row_ok, vr);
#pragma unroll
  for (int c = 0; c < ND; ++c) dka[c] = dva[c] = 0.f;

  // the queries that see some key of this tile: [q_begin, q_end)
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? (int)min((int64_t)Lq, (int64_t)k_hi + window) : Lq;

  for (int g = 0; g < gq; ++g) {
    const int h = kvh * gq + g;
    const int64_t stat0 = ((int64_t)b * H + h) * Lq;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BT * DH; idx += THREADS) {
        const int j = idx / DH, d = idx % DH;
        const int qp = q0 + j;
        const bool in = qp < q_end;
        const int64_t off = in ? (((int64_t)b * Lq + qp) * H + h) * DH + d : 0;
        Qs[j][d] = in ? to_f(q[off]) : 0.f;
        Os[j][d] = in ? to_f(dout[off]) : 0.f;
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
        for (int i = 0; i < NI; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[j][16 * i + 4 * t]);
          const float4 oo = *reinterpret_cast<const float4*>(&Os[j][16 * i + 4 * t]);
          s = fmaf(qq.x, kr[4 * i + 0], s);
          s = fmaf(qq.y, kr[4 * i + 1], s);
          s = fmaf(qq.z, kr[4 * i + 2], s);
          s = fmaf(qq.w, kr[4 * i + 3], s);
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
        for (int i = 0; i < NI; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[j][16 * i + 4 * t]);
          const float4 oo = *reinterpret_cast<const float4*>(&Os[j][16 * i + 4 * t]);
          dva[4 * i + 0] = fmaf(p, oo.x, dva[4 * i + 0]);
          dva[4 * i + 1] = fmaf(p, oo.y, dva[4 * i + 1]);
          dva[4 * i + 2] = fmaf(p, oo.z, dva[4 * i + 2]);
          dva[4 * i + 3] = fmaf(p, oo.w, dva[4 * i + 3]);
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
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[key_off + 16 * i + 4 * t + e] = from_f<T>(dka[4 * i + e] * scale);
        dv[key_off + 16 * i + 4 * t + e] = from_f<T>(dva[4 * i + e]);
      }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* dvec_ = static_cast<float*>(dvec);
  cudaError_t err = launch_dot_do_o<T, DH>(do_, static_cast<const T*>(o), dvec_, B, Lq, H, s);
  if (err != cudaSuccess) return err;
  const int bq = ROWS / (H / KVH);  // q positions per dq block
  dq_kernel<T, DH><<<dim3(B * KVH, (Lq + bq - 1) / bq), THREADS, 0, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<T*>(dq), Lq, Lk, H, KVH, bq, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DH><<<dim3(B * KVH, (Lk + ROWS - 1) / ROWS), THREADS, 0, s>>>(
      q_, k_, v_, do_, lse_, dvec_, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, KVH, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* o, const void* dout,
                        const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                        int KVH, int causal, int window, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike); lse
// (B, H, Lq) f32 from flash_attention_fwd; dvec (B, H, Lq) f32 scratch.
// route: 0 fma (f32 only), 1 mma (bf16 only, 16-byte aligned bases); the
// wrapper's _route picks it. Returns the first failing launch's cudaError_t,
// or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   const void* lse, void* dvec, void* dq, void* dk, void* dv, int dtype, int route,
                                   int B, int Lq, int Lk, int H, int KVH, int Dh, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (int64_t)Lq >= (int64_t)Lk + window)  // rows with no visible key
    return (int)cudaErrorInvalidValue;
  const int bq = ROWS / (H / KVH);
  if ((int64_t)B * KVH > 2147483647LL || (Lq + bq - 1) / bq > 65535 || (Lk + ROWS - 1) / ROWS > 65535 ||
      ((int64_t)B * Lq * H + ROWS - 1) / ROWS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
                            (uintptr_t)dk | (uintptr_t)dv;
    if (dtype != 1 || (bases & 15)) return (int)cudaErrorInvalidValue;
    return (int)mma::dispatch_dh(Dh, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window,
                                 scale, s);
  }
  if (route != 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_dh<float>(Dh, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Lq, Lk, H, KVH, causal, window,
                                 scale, s);
}
