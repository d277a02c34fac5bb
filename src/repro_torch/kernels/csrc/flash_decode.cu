// Flash decoding (single-token GQA attention over a KV cache) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (body _decode_kernel). q (B, 1, H, Dh); k, v (B, S, KVH, Dh); k_pos (B, S),
// q_pos (B,), n_valid (B,) int32; optional window. Slot s of batch row b is
// attended iff s < n_valid[b], k_pos[b, s] <= q_pos[b] and, with a window,
// k_pos[b, s] > q_pos[b] - window. Output in q's dtype (or f32 on request);
// softmax state in f32. With an lse pointer, also each row's log-sum-exp of
// its scaled, masked scores (B, H) in f32: M + log(L) of the cluster's final
// merge, NEG_INF for a row with no written slot (whose output is 0). That is
// what a flash-decoding merge across devices needs: each device's partial
// output over its slice of the slots, weighed by exp(lse - max lse).
//
// What bounds it on this card: bytes. At the serving shapes (stablelm-1.6b,
// B 4, 32 KV heads, Dh 64, ~528 valid slots, bf16) it must read ~17 MB of
// K/V and does ~17 MFLOP: one FLOP per byte, far under the break-even. A
// decode step has only B * KVH = 128 (stablelm) or 32 (jamba) (batch, KV head)
// pairs, fewer than two per SM, so one block per pair leaves the card idle.
//
// What the design does about it:
//   * The KV axis is split over the n_split blocks of a thread-block cluster:
//     grid B * KVH * n_split, cluster dims (n_split, 1, 1). Block j of the
//     cluster of (batch b, KV head h) takes the j-th contiguous chunk of
//     ceil(n / n_split) slots of the n = min(n_valid[b], S) written ones.
//     The host picks n_split so that the grid stays inside one wave of
//     resident blocks (flash_decode_blocks_per_sm); past one wave every
//     extra wave cost ~4.5 us at stablelm's decode shape.
//   * Each of a block's 8 warps takes a contiguous run of the block's slots
//     and carries its own online-softmax state (m, l, acc in f32) for all gq
//     query rows of the KV head, which stay in registers, so each K/V slot is
//     read from device memory exactly once for all of them; slots at or past
//     n_valid are never read.
//   * Every load is 16 bytes a lane, and the lanes of a slot group cover one
//     slot's contiguous head-dim run (Dh * sizeof(T) bytes), so a warp reads
//     several whole slots per instruction; each lane issues its K and V loads
//     for U slots before it uses any of them, to keep bytes in flight (staging
//     them in shared memory with cp.async, more slots in flight, measured no
//     faster).
//   * One launch: the warps merge into the block's state in shared memory;
//     after cluster.sync() every block reads the cluster's (m, l, acc)
//     through distributed shared memory and merges its slice of the outputs.
//     A second cluster.sync() keeps every block's shared memory alive until
//     the others have read it. No global scratch, no second launch.
//
// Masking keeps the reference's finite NEG_INF = -2e38: a fully masked slot
// gives p = exp(0) only while the running max is still NEG_INF, and the first
// live slot cancels it through corr = exp(m_prev - m_new) = 0; with -inf this
// would be NaN. Every merge (warps, then blocks) weights a state by
// exp(m_j - M) and special-cases nothing: an empty chunk publishes
// m = NEG_INF, l = 0, acc = 0 and adds nothing; a chunk whose slots are all
// masked by position publishes m = NEG_INF with l = its slot count, which
// weighs 0 beside a live chunk and 1 when every chunk is masked, as the
// single pass over all slots would. In bf16, P is rounded to v's dtype before
// P.V, as the Pallas kernel does. The lse of a chunk set that is all masked is
// NEG_INF + log(count), which rounds to NEG_INF in f32: beside a live slice it
// weighs exp(NEG_INF - M) = 0, as the block merge weighs a masked chunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;       // query heads per KV head (must match flash_decode.py)
constexpr int MAX_SPLIT = 8;   // blocks per cluster: the portable cluster size

// 16 bytes of T, widened to f32
__device__ __forceinline__ void widen(const uint4& raw, float (&f)[4], float) {
  f[0] = __uint_as_float(raw.x); f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z); f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float (&f)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x; f[2 * i + 1] = t.y;
  }
}

// G: query heads per KV head rounded up to a power of two (gq <= G); TO: the
// output's type (T, or float for partials that are merged later).
template <typename T, int DH, int G, typename TO>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ k_pos, const int* __restrict__ q_pos,
                    const int* __restrict__ n_valid, TO* __restrict__ o, float* __restrict__ lse,
                    int S, int H, int KVH, int window, float scale, int n_split) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPS = DH / VEC;        // lanes per slot
  constexpr int SPW = 32 / LPS;        // slots per warp per load
  constexpr int U = G <= 1 ? 8 : (G <= 2 ? 4 : 2);  // loads in flight per lane, per tensor
  constexpr int STEP = SPW * U;        // slots per warp per iteration
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "head dim vs 16-byte lanes");

  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ __align__(16) float sm_acc[WARPS][G][DH];
  __shared__ float blk_m[G], blk_l[G];  // the block's merged state, read by the cluster
  __shared__ __align__(16) float blk_acc[G][DH];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / n_split;
  const int b = bh / KVH, kvh = bh % KVH;
  const int gq = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPS, li = lane % LPS;

  float qf[G][VEC], acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + ((int64_t)b * H + kvh * gq + g) * DH + li * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[g][e] = g < gq ? to_f(qh[e]) : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  // this block's chunk of the written slots, then this warp's run of it
  const int n_lim = max(0, min(n_valid[b], S));
  const int chunk = (n_lim + n_split - 1) / n_split;
  const int lo_b = min(n_lim, split * chunk), hi_b = min(n_lim, lo_b + chunk);
  const int per = (hi_b - lo_b + WARPS - 1) / WARPS;
  const int lo = min(hi_b, lo_b + warp * per), hi = min(hi_b, lo + per);

  const int qp = q_pos[b];
  const int64_t slot_stride = (int64_t)KVH * DH;
  const T* kb = k + ((int64_t)b * S * KVH + kvh) * DH + li * VEC;
  const T* vb = v + ((int64_t)b * S * KVH + kvh) * DH + li * VEC;
  const int* pb = k_pos + (int64_t)b * S;

  // one online-softmax update over U slot groups (zeros where !in)
  auto consume = [&](const uint4 (&kr)[U], const uint4 (&vr)[U], const int (&slot)[U],
                     const bool (&in)[U]) {
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = false;
      if (in[u]) {
        const int kp = pb[slot[u]];
        ok[u] = kp <= qp && (window <= 0 || kp > qp - window);
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      widen(kr[u], kf, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qf[g][e], kf[e], part);
#pragma unroll
        for (int off = LPS / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u][g] = ok[u] ? part * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // slot groups past the run take no part: -inf scores give p = 0 here
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = in[u] ? fmaxf(mx, s[u][g]) : mx;
#pragma unroll
      for (int off = LPS; off < 32; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = in[u] ? expf(s[u][g] - m_new) : 0.f;
        ps += s[u][g];
      }
#pragma unroll
      for (int off = LPS; off < 32; off *= 2) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * corr + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      widen(vr[u], vf, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = round_as<T>(s[u][g]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  };

  for (int base = lo; base < hi; base += STEP) {
    uint4 kr[U], vr[U];
    int slot[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      slot[u] = base + u * SPW + grp;
      in[u] = slot[u] < hi;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (in[u]) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + slot[u] * slot_stride);
        vr[u] = *reinterpret_cast<const uint4*>(vb + slot[u] * slot_stride);
      }
    }
    consume(kr, vr, slot, in);
  }

  // merge the slot groups of this warp (same dims, same running max)
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int off = LPS; off < 32; off *= 2)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][li * VEC + e] = acc[g][e];
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps into the block's state
  for (int idx = threadIdx.x; idx < gq * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], c, L);
      A = fmaf(sm_acc[w][g][d], c, A);
    }
    blk_acc[g][d] = A;
    if (d == 0) {
      blk_m[g] = M;
      blk_l[g] = L;
    }
  }
  cluster.sync();  // every block's state is visible to the cluster

  // merge the cluster's blocks through distributed shared memory, each
  // block a slice of the outputs (block 0 alone measured ~1 us slower)
  for (int idx = split * THREADS + threadIdx.x; idx < gq * DH; idx += n_split * THREADS) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG_INF;
    for (int r = 0; r < n_split; ++r) M = fmaxf(M, cluster.map_shared_rank(&blk_m[0], r)[g]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float c = expf(cluster.map_shared_rank(&blk_m[0], r)[g] - M);
      L = fmaf(cluster.map_shared_rank(&blk_l[0], r)[g], c, L);
      A = fmaf(cluster.map_shared_rank(&blk_acc[0][0], r)[g * DH + d], c, A);
    }
    o[((int64_t)b * H + kvh * gq + g) * DH + d] = from_f<TO>(A / fmaxf(L, 1e-37f));
    if (lse != nullptr && d == 0) lse[(int64_t)b * H + kvh * gq + g] = L > 0.f ? M + logf(L) : NEG_INF;
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

template <typename T, int DH, int G, typename TO>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kp, const int* qp,
                   const int* nv, void* o, float* lse, int B, int S, int H, int KVH, int window,
                   float scale, int n_split, cudaStream_t stream) {
  auto kern = flash_decode_kernel<T, DH, G, TO>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KVH * n_split);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kp,
      qp, nv, static_cast<TO*>(o), lse, S, H, KVH, window, scale, n_split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int DH, int G>
cudaError_t resident(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_decode_kernel<T, DH, G, T>, THREADS, 0);
}

// one entry per (dtype, head dim, G, output type): launch, or with blocks !=
// null report how many blocks of that kernel an SM holds (the f32-output
// kernel has the same registers and shared memory)
template <typename T, int DH, typename TO>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* kp,
                       const int* qp, const int* nv, void* o, float* lse, int B, int S, int H,
                       int KVH, int window, float scale, int n_split, int* blocks, cudaStream_t s) {
  const int gq = H / KVH;
#define FD_CASE(GG)                                                                            \
  return blocks ? resident<T, DH, GG>(blocks)                                                  \
                : launch<T, DH, GG, TO>(q, k, v, kp, qp, nv, o, lse, B, S, H, KVH, window,     \
                                        scale, n_split, s)
  if (gq <= 1) FD_CASE(1);
  if (gq <= 2) FD_CASE(2);
  if (gq <= 4) FD_CASE(4);
  FD_CASE(8);
#undef FD_CASE
}

template <typename T, typename TO>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const int* kp,
                        const int* qp, const int* nv, void* o, float* lse, int B, int S, int H,
                        int KVH, int Dh, int window, float scale, int n_split, int* blocks,
                        cudaStream_t s) {
#define FD_DH(DD) \
  dispatch_g<T, DD, TO>(q, k, v, kp, qp, nv, o, lse, B, S, H, KVH, window, scale, n_split, blocks, s)
  switch (Dh) {
    case 16: return FD_DH(16);
    case 32: return FD_DH(32);
    case 64: return FD_DH(64);
    case 128: return FD_DH(128);
    default: return cudaErrorInvalidValue;
  }
#undef FD_DH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; out_f32: o is float32 (else q's dtype);
// lse: a (B, H) float32 buffer for each row's log-sum-exp, or null; n_split:
// blocks per (batch, KV head), in one cluster (1..8). Returns the launch's
// cudaError_t.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* k_pos,
                                const void* q_pos, const void* n_valid, void* o, void* lse,
                                int dtype, int out_f32, int B, int S, int H, int KVH, int Dh,
                                int window, float scale, int n_split, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (n_split < 1 || n_split > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * KVH * n_split > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int* kp = static_cast<const int*>(k_pos);
  const int* qp = static_cast<const int*>(q_pos);
  const int* nv = static_cast<const int*>(n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_dh<float, float>(q, k, v, kp, qp, nv, o, l, B, S, H, KVH, Dh, window,
                                          scale, n_split, nullptr, s);
  if (dtype == 1 && out_f32)
    return (int)dispatch_dh<__nv_bfloat16, float>(q, k, v, kp, qp, nv, o, l, B, S, H, KVH, Dh,
                                                  window, scale, n_split, nullptr, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16, __nv_bfloat16>(q, k, v, kp, qp, nv, o, l, B, S, H, KVH,
                                                          Dh, window, scale, n_split, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel for (dtype, Dh, gq) that one SM holds at once, into
// *blocks. Returns a cudaError_t.
extern "C" int flash_decode_blocks_per_sm(int dtype, int Dh, int gq, int* blocks) {
  if (gq < 1 || gq > MAX_G) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_dh<float, float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, 1, 1, gq, 1, Dh, 0, 1.f, 1, blocks,
                                          nullptr);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16, __nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                                          nullptr, nullptr, nullptr, nullptr, 1, 1,
                                                          gq, 1, Dh, 0, 1.f, 1, blocks, nullptr);
  return (int)cudaErrorInvalidValue;
}
