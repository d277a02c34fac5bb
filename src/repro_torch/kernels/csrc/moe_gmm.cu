// Grouped SwiGLU over MoE capacity bins (moe_gmm) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py::moe_gmm (body
// _gmm_kernel). Per expert e, with x (E, C, D), Wg and Wu (E, D, F) and
// Wd (E, F, D):
//   h[e]   = cast_T( silu(x[e] . Wg[e]) * (x[e] . Wu[e]) )   sums in f32
//   out[e] = cast_T( h[e] . Wd[e] )                            sums in f32
// h is cast to x's dtype exactly where the Pallas kernel casts it. Empty
// capacity rows (zeros) are computed like any other and give exact zeros.
//
// What bounds it on this card: at the prefill shape of jamba-v0.1-52b
// (E 16, C 320, D 4096, F 14336, bf16) operations: 1.80e12 FLOP against
// 5.7 GB of weights and bins (~315 FLOP per byte, above the H100's ~295
// break-even for bf16 tensor cores), so only the tensor cores come near the
// bound. At the decode shape (C 4) bytes: all 5.64 GB of expert weights are
// read to produce 16 x 4 rows.
//
// ONE CALL IS TWO PASSES behind the same C entry. The Pallas kernel keeps a
// (C-block, D) f32 accumulator in VMEM across its sequential F grid axis; at
// D = 4096 and a 64-row block that is 1 MiB, which fits no SM, and blocks run
// in no order. So:
//   1. a gated pass reads each x tile once for two products, gate and up,
//      applies SiLU and the product in f32 registers and writes h (E, C, F)
//      in x's dtype (scratch the wrapper allocates: 147 MB at the prefill
//      shape, whose round trip through HBM costs ~0.09 ms, 5% of the bound);
//   2. a down pass h . Wd with f32 sums over all of F in one block: no
//      split-F partial sums and no atomics, so the result does not depend on
//      launch order.
// The caller picks one of three routes (moe_gmm.py::_route):
//   * route 1, "wgmma" (bf16, C > 8, D and F multiples of 8): both passes are
//     one warp-specialised, persistent GEMM (one block per SM walking its
//     tiles). One producer thread issues TMA loads (128-byte swizzle, zero
//     fill past every edge, so nothing is padded in device memory) of the A
//     tile (x or h, 128 x 64) and 256 B columns (Wg's 128 and Wu's 128, or
//     Wd's 256; 64 k-rows) into a ring of 4 stages of 48 KiB, each with a
//     full and an empty mbarrier; two consumer warpgroups each run wgmma
//     m64n256k16 on 64 rows, so gate and up come out of one product and the
//     A tile is read from shared memory once (128 f32 accumulators a
//     thread). W is stored (K, N) with N contiguous, so B is read MN-major
//     through the instruction's transpose bit: no copy of the weights is
//     made. setmaxnreg gives the producer's registers to the consumers; the
//     producer fills the next tile's stages while the consumers store this
//     one. Tiles are walked with the M-tiles of one (expert, N-tile) adjacent,
//     so the blocks in flight share each weight slab through L2. No branch
//     surrounds the products (ptxas serialises wgmma on a divergent path), so
//     the rows of C's ragged last tile past C are multiplied as TMA's zeros:
//     at C 320 the tiles cover 384 rows.
//   * route 2, "swap_ab" (bf16, C <= 8: decode): the operands are swapped so
//     the weights fill the tensor core's M side: h^T (F x C) = Wg^T . x^T and
//     out^T = Wd^T . h^T, with C padded to N = 8 by zeros. Each warp owns 64
//     weight columns (128-byte rows) of one expert and streams its own 64-row
//     weight tiles through a private ring of 3 cp.async stages (16-byte
//     copies; 128 KiB of weight loads in flight per SM), with only
//     __syncwarp between tiles; ldmatrix.trans feeds mma.sync m16n8k16, and
//     each step's 16 products are added to the f32 sums with round-to-
//     nearest. Empty bins are not skipped: every expert's weights are read.
//   * route 0, "fma" (every f32 call, and bf16 where D or F is not a multiple
//     of 8, which TMA's 16-byte strides and the 16-byte copies need): the
//     first port's tiled product, unchanged: A and B tiles staged in shared
//     memory as f32, a TM x TN register tile of sums per thread (plain FMA),
//     64 x 128 tiles (8 x 128 for C <= 8). f32 stays here because the tensor
//     cores would compute f32 products in TF32, which breaks the reference's
//     f32 parity.
//
// THE BACKWARD (moe_gmm_bwd, K7a) has no Pallas counterpart: the JAX train
// step differentiates the einsums of repro/models/moe.py:127-131. Per expert,
// with dY the cotangent of out:
//   g = x.Wg, u = x.Wu (recomputed), dH = dY.Wd^T,  s = sigmoid(g)
//   h  = cast_T( silu(g) u )                  dWd = h^T . dY
//   dG = cast_T( dH u s (1 + g (1 - s)) )     dU  = cast_T( dH silu(g) )
//   dX = dG.Wg^T + dU.Wu^T                    dWg = x^T.dG, dWu = x^T.dU
// dG and dU are rounded to x's dtype before their products, as h is in the
// forward. What bounds it: operations, 16 E C D F (12 of the gradients and 4
// of the recompute; 9.7 ms at jamba's training bins E 16, C 640 on the bf16
// tensor cores; the bytes, ~12 GB of weights and their gradients, take 3.6
// ms). Each pass is a batched product over the experts whose K loop runs
// whole inside one block (the weight gradients sum over C in a fixed order:
// no split-K, no float atomics, so a repeated call is bit-equal).
//   * route 2, "wgmma" (bf16, D and F multiples of 8): five passes on the
//     forward's machinery (namespace wg: TMA with the 128-byte swizzle and
//     zero fill past every edge, a 4-stage mbarrier ring, one producer
//     thread, two consumer warpgroups, setmaxnreg, persistent blocks), every
//     product wgmma m64n256k16 on 128 x 256 tiles:
//       0. dH = dY.Wd^T (C x F over D) into f32 scratch (dh);
//       1. g, u = x.[Wg Wu] (C x F over D, gate and up of 128 columns in
//          one product) with the epilogue that reads dH and writes h, dG and
//          dU (E, C, F) in x's dtype;
//       2. dWd = h^T . dY (F x D over C);
//       3. dX = [dG dU] . [Wg Wu]^T (C x D over 2F, one K loop);
//       4. dWg and dWu = x^T . [dG dU] (D x F over C, x read once for both).
//     Operands are read in their stored layouts: one whose stored rows run
//     along the reduction (h and x as A in passes 2 and 4; Wg and Wu in
//     pass 1, dY in pass 2, dG and dU in pass 4 as B) is read MN-major
//     through the product's transpose bits; no transposed copy is made. The
//     epilogues store 16 bytes a lane (quad_transpose): stores of 4 bytes,
//     half a sector each, made passes 2 and 4 markedly slower. dH goes
//     through f32 scratch because a pass 1 fused with it (three products on
//     two A tiles, m64n128 and m64n64 to fit the accumulators) measured
//     slower than the two passes: a narrow product reads more shared memory
//     a FLOP. Pairs of blocks in clusters that multicast the shared operand
//     (halving its L2 traffic) measured no faster, so L2 is not what holds
//     the passes.
//   * route 1, "mma": the first design (64 x 64 tiles of mma.sync m16n8k16,
//     cp.async and ldmatrix, four passes with dH fused into the first); no
//     longer chosen, kept as the baseline chip_smoke.py times beside wgmma.
//   * route 0, "fma" (every f32 call, and bf16 where D or F is not a
//     multiple of 8): 64 x 64 tiles of plain FMA in f32, as the forward's
//     FMA route, so f32 keeps the reference's f32 parity.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tc.cuh"

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


// ---------------------------------------------------------------------------
// route 1: warp-specialised wgmma GEMM fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 384;                  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int A_BYTES = BM * BK * 2;          // 16 KiB: 128 rows of 128 bytes
constexpr int B_HALF = BK * 64 * 2;           // 8 KiB: 64 k-rows of 64 columns (128 bytes)

// A stage holds the A tile (128 x 64) and 256 B columns as four 64-column
// chunks B_HALF bytes apart: Wg's 128 columns then Wu's for the gated pass,
// Wd's 256 for the down pass. One wgmma m64n256k16 a warpgroup covers all of
// them, so the A tile is read from shared memory once for gate and up: 128
// f32 accumulators a thread (gate in the first 64, up in the last 64).
constexpr int B_BYTES = 4 * B_HALF;           // 32 KiB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment slack
template <bool GATED> struct Shape {
  static constexpr int BN = GATED ? 128 : 256;  // output columns of a tile
  static constexpr int NB = GATED ? 2 : 1;      // weight matrices read
};

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N), bf16 in, f32 sums, bf16 out,
// for e < E. GATED: B0 = Wg, B1 = Wu and out = silu(A.B0) * (A.B1). Every
// tile edge (M, N, K) is zero-filled by TMA; stores are masked.
// Persistent: each block walks the tiles blockIdx.x, + gridDim.x, ..., with
// the M-tiles of one (expert, N-tile) adjacent in that order, so the blocks
// in flight share weight slabs through L2; the producer fills the next
// tile's stages while the consumers store this one.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(__grid_constant__ const CUtensorMap mA, __grid_constant__ const CUtensorMap mB0,
            __grid_constant__ const CUtensorMap mB1, __nv_bfloat16* __restrict__ out, int E, int M, int N, int K) {
  using S = Shape<GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + S::BN - 1) / S::BN;
  const int tiles = m_tiles * n_tiles * E;
  const int nk = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full, across tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;  // k-tiles loaded so far by this block
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles % n_tiles) * S::BN;
        const int e = tile / (m_tiles * n_tiles);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);  // zero-filled bytes count too
          tma_load_3d(st, &mA, &full[s], kt * BK, m0, e);
#pragma unroll
          for (int c = 0; c < 4; ++c)  // chunk c: columns 64 (c % (BN / 64)) of matrix c / (BN / 64)
            tma_load_3d(st + A_BYTES + c * B_HALF, c < 4 / S::NB ? &mB0 : &mB1, &full[s],
                        n0 + 64 * (c % (4 / S::NB)), kt * BK, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns rows m0 + 64 wgi .. + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[128];
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    int it = 0;  // k-tiles consumed so far by this block
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles % n_tiles) * S::BN;
      const int e = tile / (m_tiles * n_tiles);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE_BYTES;
        const uint8_t* a = st + wgi * (64 * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // 16 k-values are 32 bytes along an A row, 16 k-rows (2048 bytes) of B
          wgmma_m64n256k16_ss<1>(acc, sw128_desc(a + kk * 32, 16, 1024),
                                 sw128_desc(st + A_BYTES + kk * 2048, B_HALF, 1024), 1);
        }
        wgmma_commit();
        // the previous k-tile's products are done: hand its stage back
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last stage

      // accumulator layout: value 4j + 2i + c at row 16 warp + lane/4 + 8i,
      // column 8j + 2 (lane % 4) + c of the 256; gated, gate column j pairs
      // with up column j + 16
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + wgi * 64 + warp * 16 + lane / 4 + 8 * i;
        if (row >= M) continue;
        __nv_bfloat16* orow = out + ((int64_t)e * M + row) * N;
#pragma unroll
        for (int j = 0; j < S::BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= N) continue;  // N is a multiple of 8: the pair is whole
          float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if constexpr (GATED) {
            v0 = silu(v0) * acc[4 * (j + 16) + 2 * i];
            v1 = silu(v1) * acc[4 * (j + 16) + 2 * i + 1];
          }
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// out (E, M, N) = A (E, M, K) . B (E, K, N) [gated with B1]
template <bool GATED>
cudaError_t launch(const void* A, const void* B0, const void* B1, void* out, int E, int M, int N, int K,
                   cudaStream_t stream) {
  using S = Shape<GATED>;
  CUtensorMap mA, mB0, mB1;
  if (!make_map(&mA, A, E, M, K, BM) || !make_map(&mB0, B0, E, K, N, BK) ||
      !make_map(&mB1, GATED ? B1 : B0, E, K, N, BK))
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * ((N + S::BN - 1) / S::BN) * E;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);  // one persistent block per SM
  gemm_kernel<GATED><<<grid, THREADS, SMEM, stream>>>(mA, mB0, mB1, static_cast<__nv_bfloat16*>(out), E, M,
                                                          N, K);
  return cudaGetLastError();
}

// ---- the backward's passes (K7a, route "wgmma") ---------------------------
// The forward's machinery (TMA with the 128-byte swizzle and zero fill, a ring
// of STAGES stages with full and empty mbarriers, one producer thread, two
// consumer warpgroups of 64 rows, setmaxnreg, persistent blocks walking the
// M-tiles of one (expert, N-tile) adjacently) with each pass's operands read
// in their stored layouts, and every product m64n256k16 (128 f32
// accumulators a thread). A stage is 6 CHUNKs: 64 rows of 128 bytes (64
// bf16), the span of one swizzle row, 1024-byte aligned. Descriptors:
//   K-major tile (rows M or N, 64 k along a row): sw128_desc(tile + 32 kk,
//     16, 1024) at k-step kk (16 k are 32 bytes along the rows; the stride
//     offset is the 8-row group; the leading offset is unused);
//   MN-major tile (rows k, 64 M or N along a row, chunks of 64 columns
//     CHUNK apart): sw128_desc(tile + 2048 kk, CHUNK, 1024) (a k-step is 16
//     rows; the leading offset is the distance to the next 64 columns; A's
//     64 rows of a warpgroup are one chunk, so for A it is never used).
// Pass 0 (C x F over D, BN 256): dH = dY.Wd^T in f32 to scratch: dY [128][64
//   d] (K-major A), Wd [256 f][64 d] (K-major B: Wd is (F, D) = (n, k)).
// Pass 1 (C x F over D, BN 128): x [128][64 d] (K-major A), Wg's and Wu's
//   chunks [64 d][64 f] (MN-major B): gate and up of 128 columns in one
//   product, A read once, as the forward's gated pass; the epilogue reads dH
//   and writes h, dG and dU.
// Pass 2 (F x D over C, BN 256): h chunks [64 c][64 f] x 2 (MN-major A, the
//   transpose bit), dY chunks [64 c][64 d] x 4 (MN-major B).
// Pass 3 (C x D over 2F, BN 256): dG or dU [128][64 f] (K-major A), Wg or Wu
//   [256 d][64 f] (K-major B); k-tiles 0 .. nk - 1 on dG and Wg, then
//   nk .. 2 nk - 1 on dU and Wu, one accumulator.
// Pass 4 (D x F over C, BN 128): x chunks [64 c][64 d] x 2 (MN-major A), dG
//   chunks then dU chunks [64 c][64 f] x 2 each (MN-major B): one product
//   gives dWg's 128 columns and dWu's.
// dH goes through f32 scratch rather than into pass 1 as a third product:
// beside gate and up (on x) it needs its own A (dY), and two products on two
// A tiles fit a thread's accumulators only as m64n128 and m64n64, which read
// more shared memory a FLOP than m64n256 (see the note at the top).
constexpr int CHUNK = 64 * 128;
constexpr int BWD_STAGE = 6 * CHUNK;
constexpr int BWD_SMEM = STAGES * BWD_STAGE + 2 * STAGES * 8 + 1024;
static_assert(BWD_SMEM <= 232448, "over the 227 KB a block may use");

struct Maps {  // the pass's tensor maps (see bwd_passes)
  CUtensorMap a0, a1, b0, b1;
};

template <int P>
__host__ __device__ constexpr int bwd_bn() { return P == 1 || P == 4 ? 128 : 256; }

// the TMA loads of k-tile kt of the tile at (m0, n0, e) into stage st
template <int P>
__device__ __forceinline__ void bwd_load(uint8_t* st, const Maps& mp, uint64_t* bar, int kt, int nk, int m0, int n0,
                                         int e) {
  if constexpr (P == 0 || P == 3) {  // A and B both K-major
    const bool up = P == 3 && kt >= nk;
    const int k0 = (up ? kt - nk : kt) * BK;
    tma_load_3d(st, up ? &mp.a1 : &mp.a0, bar, k0, m0, e);              // dY (E, C, D); dG or dU (E, C, F)
    tma_load_3d(st + 2 * CHUNK, up ? &mp.b1 : &mp.b0, bar, k0, n0, e);  // Wd (E, F, D); Wg or Wu (E, D, F)
  } else if constexpr (P == 1) {
    const int k0 = kt * BK;
    tma_load_3d(st, &mp.a0, bar, k0, m0, e);  // x (E, C, D)
#pragma unroll
    for (int c = 0; c < 4; ++c)  // Wg's 128 columns, then Wu's (E, D, F)
      tma_load_3d(st + (2 + c) * CHUNK, c < 2 ? &mp.b0 : &mp.b1, bar, n0 + 64 * (c % 2), k0, e);
  } else {  // passes 2 and 4: A and B both MN-major, rows k
    const int k0 = kt * BK;
#pragma unroll
    for (int c = 0; c < 2; ++c) tma_load_3d(st + c * CHUNK, &mp.a0, bar, m0 + 64 * c, k0, e);  // h or x
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (P == 2) tma_load_3d(st + (2 + c) * CHUNK, &mp.b0, bar, n0 + 64 * c, k0, e);  // dY
      else tma_load_3d(st + (2 + c) * CHUNK, c < 2 ? &mp.b0 : &mp.b1, bar, n0 + 64 * (c % 2), k0, e);  // dG, dU
    }
  }
}

// k-step kk of a stage's product for warpgroup wgi
template <int P>
__device__ __forceinline__ void bwd_product(float (&acc)[128], const uint8_t* st, int wgi, int kk) {
  if constexpr (P == 0 || P == 3) {
    wgmma_m64n256k16_ss<0>(acc, sw128_desc(st + wgi * CHUNK + kk * 32, 16, 1024),
                           sw128_desc(st + 2 * CHUNK + kk * 32, 16, 1024), 1);
  } else if constexpr (P == 1) {
    wgmma_m64n256k16_ss<1>(acc, sw128_desc(st + wgi * CHUNK + kk * 32, 16, 1024),
                           sw128_desc(st + 2 * CHUNK + kk * 2048, CHUNK, 1024), 1);
  } else {
    wgmma_m64n256k16_ss<1, 1>(acc, sw128_desc(st + wgi * CHUNK + kk * 2048, CHUNK, 1024),
                              sw128_desc(st + 2 * CHUNK + kk * 2048, CHUNK, 1024), 1);
  }
}

// The 4 x 4 transpose across a quad of lanes (lane % 4 = t) by two shuffle
// steps: lane t gives p[c], its two columns of 8-column group c of a row, and
// gets group t's 8 columns, [p_0[t], p_1[t], p_2[t], p_3[t]] of lanes 0 .. 3,
// for one 16-byte store (4 times fewer than by pairs).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&p)[4], int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  uint32_t x[4], y[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // swap the 2 x 2 blocks' off-diagonal entries between lanes t and t ^ 1
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b0 ? p[2 * k] : p[2 * k + 1], 1);
    x[2 * k] = b0 ? r : p[2 * k];
    x[2 * k + 1] = b0 ? p[2 * k + 1] : r;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // then the 2 x 2 blocks between lanes t and t ^ 2
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? x[k] : x[k + 2], 2);
    y[k] = b1 ? r : x[k];
    y[k + 2] = b1 ? x[k + 2] : r;
  }
  return make_uint4(y[0], y[1], y[2], y[3]);
}

// Pass P of the backward: out (E, M, N) tiles of BM x bwd_bn<P>() over K (pass
// 3: 2K), bf16 in, f32 sums, stores masked past M and N; dh (E, M, N) f32 is
// pass 0's output and pass 1's input.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(__grid_constant__ const Maps mp, __nv_bfloat16* __restrict__ o0, __nv_bfloat16* __restrict__ o1,
           __nv_bfloat16* __restrict__ o2, float* __restrict__ dh, int E, int M, int N, int K) {
  constexpr int BN = bwd_bn<P>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * BWD_STAGE);
  uint64_t* empty = full + STAGES;

  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles * E;
  const int nk = (K + BK - 1) / BK;
  const int kts = P == 3 ? 2 * nk : nk;  // pass 3 runs over dG then dU
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full, across tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles % n_tiles) * BN;
        const int e = tile / (m_tiles * n_tiles);
        for (int kt = 0; kt < kts; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], BWD_STAGE);  // zero-filled bytes count too
          bwd_load<P>(smem + s * BWD_STAGE, mp, &full[s], kt, nk, m0, n0, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns rows m0 + 64 wgi .. + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[128];
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles % n_tiles) * BN;
      const int e = tile / (m_tiles * n_tiles);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < kts; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = smem + s * BWD_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) bwd_product<P>(acc, st, wgi, kk);
        wgmma_commit();
        // the previous k-tile's products are done: hand its stage back
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last stage

      // accumulator value 4j + 2i + c at row 16 warp + lane/4 + 8i, column
      // 8j + 2 (lane % 4) + c. The bf16 outputs: a quad's lanes share the row
      // and trade pairs (quad_transpose) so that each stores 8 columns, one
      // 8-column group of 4; N is a multiple of 8, so a group is whole. Every
      // lane takes part in the shuffles; rows past M and columns past N are
      // neither stored nor read.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + wgi * 64 + warp * 16 + lane / 4 + 8 * i;
        const int64_t base = ((int64_t)e * M + row) * N;
        if constexpr (P == 0) {  // f32 pairs: a warp's store is 8 whole 32-byte sectors
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = n0 + 8 * j + 2 * tq;
            if (row < M && col < N)
              *reinterpret_cast<float2*>(dh + base + col) = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
        } else if constexpr (P == 1) {
          // gate column j pairs with up column j + 16 and dH's same column; as EPI_GATED
#pragma unroll
          for (int jg = 0; jg < 4; ++jg) {
            uint32_t hp[4], gp[4], up[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = 4 * jg + c, col = n0 + 8 * j + 2 * tq;
              const float2 d2 = row < M && col < N ? *reinterpret_cast<const float2*>(dh + base + col)
                                                   : make_float2(0.f, 0.f);
              float hv[2], gv[2], uv[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float g = acc[4 * j + 2 * i + h], u = acc[4 * (j + 16) + 2 * i + h], dv = h ? d2.y : d2.x;
                const float ex = expf(-g), sg = 1.f / (1.f + ex), sl = g / (1.f + ex);
                hv[h] = sl * u;
                gv[h] = dv * u * (sg * (1.f + g * (1.f - sg)));
                uv[h] = dv * sl;
              }
              hp[c] = pack_bf16(hv[0], hv[1]);
              gp[c] = pack_bf16(gv[0], gv[1]);
              up[c] = pack_bf16(uv[0], uv[1]);
            }
            const uint4 hq = quad_transpose(hp, lane), gq = quad_transpose(gp, lane), uq = quad_transpose(up, lane);
            const int col = n0 + 8 * (4 * jg + tq);
            if (row < M && col < N) {
              *reinterpret_cast<uint4*>(o0 + base + col) = hq;
              *reinterpret_cast<uint4*>(o1 + base + col) = gq;
              *reinterpret_cast<uint4*>(o2 + base + col) = uq;
            }
          }
        } else {
          // pass 4: groups 0 .. 3 are dWg's 128 columns, 4 .. 7 dWu's, both at n0
#pragma unroll
          for (int jg = 0; jg < 8; ++jg) {
            uint32_t pk[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              pk[c] = pack_bf16(acc[4 * (4 * jg + c) + 2 * i], acc[4 * (4 * jg + c) + 2 * i + 1]);
            const uint4 v = quad_transpose(pk, lane);
            const int col = n0 + 8 * (4 * (P == 4 ? jg % 4 : jg) + tq);
            __nv_bfloat16* o = P == 4 && jg >= 4 ? o1 : o0;
            if (row < M && col < N) *reinterpret_cast<uint4*>(o + base + col) = v;
          }
        }
      }
    }
  }
}

template <int P>
cudaError_t bwd_launch(const Maps& mp, void* o0, void* o1, void* o2, float* dh, int E, int M, int N, int K, int sms,
                       cudaStream_t stream) {
  constexpr int BN = bwd_bn<P>();
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * E;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);  // one persistent block per SM
  auto o = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  bwd_kernel<P><<<grid, THREADS, BWD_SMEM, stream>>>(mp, o(o0), o(o1), o(o2), dh, E, M, N, K);
  return cudaGetLastError();
}

// The backward's five passes (see the note above CHUNK); x, dy (E, C, D), the
// weights and the (E, C, F) scratch h, dg, du are bf16 with 16-byte rows, dh
// (E, C, F) f32 scratch.
inline cudaError_t bwd_passes(const void* x, const void* wgt, const void* wup, const void* wdn, const void* dy, void* h,
                              void* dg, void* du, float* dh, void* dx, void* dwg, void* dwu, void* dwd, int E, int C,
                              int D, int F, cudaStream_t s) {
  Maps m0{}, m1{}, m2{}, m3{}, m4{};
  // make_map(map, base, depth, rows, inner, box_rows): boxes of 64 inner x box_rows
  if (!make_map(&m0.a0, dy, E, C, D, BM) || !make_map(&m0.b0, wdn, E, F, D, 256) ||  // pass 0
      !make_map(&m1.a0, x, E, C, D, BM) || !make_map(&m1.b0, wgt, E, D, F, BK) ||
      !make_map(&m1.b1, wup, E, D, F, BK) ||                                          // pass 1
      !make_map(&m2.a0, h, E, C, F, BK) || !make_map(&m2.b0, dy, E, C, D, BK) ||      // pass 2
      !make_map(&m3.a0, dg, E, C, F, BM) || !make_map(&m3.a1, du, E, C, F, BM) ||
      !make_map(&m3.b0, wgt, E, D, F, 256) || !make_map(&m3.b1, wup, E, D, F, 256) ||  // pass 3
      !make_map(&m4.a0, x, E, C, D, BK) || !make_map(&m4.b0, dg, E, C, F, BK) ||
      !make_map(&m4.b1, du, E, C, F, BK))  // pass 4
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // 0. dH = dY.Wd^T (C x F over D), f32
  if ((err = bwd_launch<0>(m0, nullptr, nullptr, nullptr, dh, E, C, F, D, sms, s)) != cudaSuccess) return err;
  // 1. g = x.Wg, u = x.Wu (C x F over D) and dH -> h, dG, dU
  if ((err = bwd_launch<1>(m1, h, dg, du, dh, E, C, F, D, sms, s)) != cudaSuccess) return err;
  // 2. dWd = h^T.dY (F x D over C)
  if ((err = bwd_launch<2>(m2, dwd, nullptr, nullptr, nullptr, E, F, D, C, sms, s)) != cudaSuccess) return err;
  // 3. dX = dG.Wg^T + dU.Wu^T (C x D over F, twice, in one K loop)
  if ((err = bwd_launch<3>(m3, dx, nullptr, nullptr, nullptr, E, C, D, F, sms, s)) != cudaSuccess) return err;
  // 4. dWg = x^T.dG, dWu = x^T.dU (D x F over C)
  return bwd_launch<4>(m4, dwg, dwu, nullptr, nullptr, E, D, F, C, sms, s);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// route 2: swapped operands for bins of at most 8 rows (decode)
// ---------------------------------------------------------------------------
namespace swab {

constexpr int WARPS = 2, THREADS = 32 * WARPS;
constexpr int MT = 64;           // weight columns per warp (the mma's M side): 128-byte rows
constexpr int BK = 64;           // k-rows per stage
constexpr int STAGES = 3;
constexpr int NCH = MT / 8;      // 16-byte chunks per weight k-row
constexpr int W_TILE = BK * MT;  // elements of one weight tile
constexpr int XROW = BK + 8;     // padded row of the (8, BK) activation tile: conflict-free fragment loads
constexpr int X_TILE = 8 * XROW;

template <bool GATED>
__host__ __device__ constexpr int stage_elems() { return (GATED ? 2 : 1) * W_TILE + X_TILE; }

// Element offset of chunk c of weight k-row r. The chunk index is XORed with
// bits of the row so that the 8 consecutive k-rows one ldmatrix.trans phase
// reads fall in 8 different bank groups.
__device__ __forceinline__ int w_off(int r, int c) {
  constexpr int SW = NCH >= 8 ? 8 : NCH;
  constexpr int DIV = 8 / SW;
  return r * MT + ((c ^ ((r / DIV) & (SW - 1))) << 3);
}

// out[e] (C x M) = A[e] (C x K) . W[e] (K x M), computed as out^T = W^T . A^T
// with the weights on the mma's M side and the C <= 8 rows of A zero-padded
// to its N = 8. GATED: W0 = Wg, W1 = Wu, out = silu(A.W0) * (A.W1).
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
swap_ab_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W0,
               const __nv_bfloat16* __restrict__ W1, __nv_bfloat16* __restrict__ out, int C, int M, int K) {
  constexpr int STAGE = stage_elems<GATED>();
  constexpr int MTILES = MT / 16;
  extern __shared__ __align__(16) __nv_bfloat16 sw_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.y;
  const int m0 = (blockIdx.x * WARPS + warp) * MT;
  if (m0 >= M) return;  // the warps share nothing: no block barrier follows
  __nv_bfloat16* ring = sw_smem + warp * STAGES * STAGE;
  const __nv_bfloat16* Ae = A + (int64_t)e * C * K;
  const __nv_bfloat16* W0e = W0 + (int64_t)e * K * M;
  const __nv_bfloat16* W1e = GATED ? W1 + (int64_t)e * K * M : W0e;
  const int nk = (K + BK - 1) / BK;

  auto issue = [&](int kt) {
    __nv_bfloat16* st = ring + (kt % STAGES) * STAGE;
    const int k0 = kt * BK;
#pragma unroll
    for (int idx = lane; idx < BK * NCH; idx += 32) {
      const int r = idx / NCH, c = idx % NCH;
      const int gk = k0 + r, gm = m0 + 8 * c;
      const bool ok = gk < K && gm < M;  // M is a multiple of 8: a chunk is whole
      const int64_t off = ok ? (int64_t)gk * M + gm : 0;
      cp_async16(st + w_off(r, c), W0e + off, ok);
      if constexpr (GATED) cp_async16(st + W_TILE + w_off(r, c), W1e + off, ok);
    }
    __nv_bfloat16* xs = st + (GATED ? 2 : 1) * W_TILE;
#pragma unroll
    for (int idx = lane; idx < BK; idx += 32) {  // 8 rows of BK / 8 chunks
      const int n = idx / (BK / 8), c = idx % (BK / 8);
      const int gk = k0 + 8 * c;
      const bool ok = n < C && gk < K;  // rows past C are the zero padding
      cp_async16(xs + n * XROW + 8 * c, Ae + (ok ? (int64_t)n * K + gk : 0), ok);
    }
  };

  float g[MTILES][4], u[MTILES][4];
#pragma unroll
  for (int t = 0; t < MTILES; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[t][i] = u[t][i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of tile kt have landed
    __syncwarp();                 // ... and every lane's; tile kt-1 is read by all
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* st = ring + (kt % STAGES) * STAGE;
    const __nv_bfloat16* xs = st + (GATED ? 2 : 1) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B fragment: x^T[k][n] = x[n][k], two consecutive k of row n = lane / 4
      const __nv_bfloat16* xb = xs + (lane >> 2) * XROW + kk * 16 + 2 * (lane & 3);
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 8);
      // A fragments (16 weight columns x 16 k) from k-rows stored column-contiguous
      const int k = kk * 16 + mr + 8 * (mi >> 1);
#pragma unroll
      for (int t = 0; t < MTILES; ++t) {
        // 16 products a step on the tensor cores, added to the sums in f32
        // with round-to-nearest: the tensor cores' own accumulation rounds
        // less exactly, and the adds cost nothing here (the loop waits on
        // weight bytes)
        uint32_t a[4];
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        ldsm_x4_trans(a, st + w_off(k, 2 * t + (mi & 1)));
        mma_16816(p, a, b0, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) g[t][i] += p[i];
        if constexpr (GATED) {
          float q[4] = {0.f, 0.f, 0.f, 0.f};
          ldsm_x4_trans(a, st + W_TILE + w_off(k, 2 * t + (mi & 1)));
          mma_16816(q, a, b0, b1);
#pragma unroll
          for (int i = 0; i < 4; ++i) u[t][i] += q[i];
        }
      }
    }
  }
  cp_async_wait<0>();

  // value i of tile t at weight column m0 + 16 t + lane/4 + 8 (i / 2), bin row 2 (lane % 4) + i % 2
#pragma unroll
  for (int t = 0; t < MTILES; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 16 * t + (lane >> 2) + 8 * (i >> 1), n = 2 * (lane & 3) + (i & 1);
      if (n < C && m < M) {
        const float r = GATED ? silu(g[t][i]) * u[t][i] : g[t][i];
        out[((int64_t)e * C + n) * M + m] = __float2bfloat16(r);
      }
    }
}

template <bool GATED>
cudaError_t launch(const void* A, const void* W0, const void* W1, void* out, int E, int C, int M, int K,
                   cudaStream_t stream) {
  const int smem = WARPS * STAGES * stage_elems<GATED>() * 2;
  cudaError_t err =
      cudaFuncSetAttribute(swap_ab_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + WARPS * MT - 1) / (WARPS * MT), E);
  swap_ab_kernel<GATED><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(W0),
      static_cast<const __nv_bfloat16*>(W1), static_cast<__nv_bfloat16*>(out), C, M, K);
  return cudaGetLastError();
}

}  // namespace swab

enum Route { ROUTE_FMA = 0, ROUTE_WGMMA = 1, ROUTE_SWAP_AB = 2 };
enum BwdRoute { BWD_FMA = 0, BWD_MMA = 1, BWD_WGMMA = 2 };  // moe_gmm.py's BWD_ROUTES

// ---------------------------------------------------------------------------
// the backward (K7a)
// ---------------------------------------------------------------------------
namespace bwd {

// Epilogues. GATED: (g, u, dH) -> h, dG, dU. ONE: out0 = acc0. SUM: out0 =
// acc0 + acc1. PAIR: out0 = acc0, out1 = acc1.
enum Epi { EPI_GATED = 0, EPI_ONE = 1, EPI_SUM = 2, EPI_PAIR = 3 };

// out_j[e] (M x N) from NACC products acc_j = A_{a(j)}[e] (M x K) . B_j[e]
// (K x N). Operand element (e, r, c) of a matrix stored (rows x cols) lies at
// p + e * se + r * ld + c. A is stored [m][k] (A_KC) or [k][m]; B_j [n][k]
// (bit j of B_KC) or [k][n]; a(j) = bit j of A1_OF.
template <typename T>
struct Args {
  const T* a[2];
  int64_t sa[2];
  int lda[2];
  const T* b[3];
  int64_t sb[3];
  int ldb[3];
  T* out[3];
  int M, N, K;
};

template <typename T, int EPI, int NACC>
__device__ __forceinline__ void store_epi(const Args<T>& p, int64_t idx, const float (&v)[NACC]) {
  if constexpr (EPI == EPI_GATED) {
    const float g = v[0], u = v[1], dh = v[2];
    const float e = expf(-g), s = 1.f / (1.f + e), silu = g / (1.f + e);
    p.out[0][idx] = from_f<T>(silu * u);
    p.out[1][idx] = from_f<T>(dh * u * (s * (1.f + g * (1.f - s))));
    p.out[2][idx] = from_f<T>(dh * silu);
  } else if constexpr (EPI == EPI_ONE) {
    p.out[0][idx] = from_f<T>(v[0]);
  } else if constexpr (EPI == EPI_SUM) {
    p.out[0][idx] = from_f<T>(v[0] + v[1]);
  } else {
    p.out[0][idx] = from_f<T>(v[0]);
    p.out[1][idx] = from_f<T>(v[1]);
  }
}

namespace tc {  // route "mma"

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int KROW = BK + 8;  // a [outer][k] tile's row: 80 bytes, conflict-free ldmatrix
constexpr int OROW = 64 + 8;  // a [k][outer] tile's row: 144 bytes, conflict-free ldmatrix
constexpr int TILE = 64 * KROW;  // elements of one staged tile (the larger layout)
static_assert(BK * OROW <= TILE, "either layout fits a tile");

template <int NA, int NACC>
__host__ __device__ constexpr int smem_bytes() { return 2 * (NA + NACC) * TILE * 2; }

// stage a 64 (outer: m or n) x 32 (k) tile of an operand stored [outer][k]
// (kc) or [k][outer]; 16-byte chunks past an edge are zeros
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, int ld, int o0, int k0,
                                          int O, int K, bool kc) {
#pragma unroll
  for (int c = threadIdx.x; c < 256; c += THREADS) {
    int o, k;
    __nv_bfloat16* dst;
    if (kc) {
      o = o0 + c / 4, k = k0 + 8 * (c % 4);
      dst = s + (c / 4) * KROW + 8 * (c % 4);
    } else {
      k = k0 + c / 8, o = o0 + 8 * (c % 8);
      dst = s + (c / 8) * OROW + 8 * (c % 8);
    }
    const bool ok = o < O && k < K;
    const int64_t off = ok ? (kc ? (int64_t)o * ld + k : (int64_t)k * ld + o) : 0;
    cp_async16(dst, g + off, ok);
  }
}

// A fragment (m16 x k16) at tile row mb, depth kb: a0..a3 of mma m16n8k16
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s, int mb, int kb, int lane,
                                       bool kc) {
  const int j = lane >> 3, r = lane & 7;
  if (kc) ldsm_x4(a, s + (mb + r + 8 * (j & 1)) * KROW + kb + 8 * (j >> 1));
  else ldsm_x4_trans(a, s + (kb + r + 8 * (j >> 1)) * OROW + mb + 8 * (j & 1));
}

// B fragments (k16 x n16) at tile column nb, depth kb: (b0, b1) of n-tile nb
// in b[0], b[1] and of n-tile nb + 8 in b[2], b[3]
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* s, int nb, int kb, int lane,
                                       bool kc) {
  const int j = lane >> 3, r = lane & 7;
  if (kc) ldsm_x4(b, s + (nb + r + 8 * (j >> 1)) * KROW + kb + 8 * (j & 1));
  else ldsm_x4_trans(b, s + (kb + r + 8 * (j & 1)) * OROW + nb + 8 * (j >> 1));
}

template <int NA, int NACC, bool A_KC, int B_KC, int A1_OF, int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Args<__nv_bfloat16> p) {
  constexpr int STAGE = (NA + NACC) * TILE;
  extern __shared__ __align__(16) __nv_bfloat16 bwd_smem[];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int M = p.M, N = p.N, K = p.K;

  auto stage = [&](int st, int k0) {
    __nv_bfloat16* sm = bwd_smem + st * STAGE;
#pragma unroll
    for (int t = 0; t < NA; ++t) load_tile(sm + t * TILE, p.a[t] + e * p.sa[t], p.lda[t], m0, k0, M, K, A_KC);
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      load_tile(sm + (NA + j) * TILE, p.b[j] + e * p.sb[j], p.ldb[j], n0, k0, N, K, (B_KC >> j) & 1);
    cp_async_commit();
  };

  float acc[NACC][2][4][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][mi][ni][i] = 0.f;

  const int nk = (K + BK - 1) / BK;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) stage((kt + 1) & 1, (kt + 1) * BK);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* sm = bwd_smem + (kt & 1) * STAGE;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t af[NA][2][4];
#pragma unroll
      for (int t = 0; t < NA; ++t)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) frag_a(af[t][mi], sm + t * TILE, wm + 16 * mi, kb, lane, A_KC);
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        uint32_t bf[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          frag_b(bf[np], sm + (NA + j) * TILE, wn + 16 * np, kb, lane, (B_KC >> j) & 1);
        const int ta = (A1_OF >> j) & 1;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_16816(acc[j][mi][ni], af[ta][mi], bf[ni >> 1][2 * (ni & 1)], bf[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
    __syncthreads();  // this stage is read by all before it is staged again
  }
  cp_async_wait<0>();

  // value i of (mi, ni) at row wm + 16 mi + lane/4 + 8 (i / 2), column wn + 8 ni + 2 (lane % 4) + i % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + 16 * mi + (lane >> 2) + 8 * (i >> 1);
        const int col = n0 + wn + 8 * ni + 2 * (lane & 3) + (i & 1);
        if (row < M && col < N) {
          float v[NACC];
#pragma unroll
          for (int j = 0; j < NACC; ++j) v[j] = acc[j][mi][ni][i];
          store_epi<__nv_bfloat16, EPI, NACC>(p, ((int64_t)e * M + row) * N + col, v);
        }
      }
}

}  // namespace tc

namespace ffma {  // route "fma"

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, TX = BN / TN, THREADS = (BM / TM) * TX;

template <typename T, int NA, int NACC, bool A_KC, int B_KC, int A1_OF, int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Args<T> p) {
  __shared__ float As[NA][BK][BM + 1];
  __shared__ float Bs[NACC][BK][BN];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int M = p.M, N = p.N, K = p.K;

  float acc[NACC][TM][TN];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) acc[j][i][jj] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive elements of the stored rows
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const T* a = p.a[t] + e * p.sa[t];
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int m = A_KC ? idx / BK : idx % BM, k = A_KC ? idx % BK : idx / BM;
        const int gm = m0 + m, gk = k0 + k;
        As[t][k][m] = (gm < M && gk < K)
                          ? to_f(a[A_KC ? (int64_t)gm * p.lda[t] + gk : (int64_t)gk * p.lda[t] + gm])
                          : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const T* b = p.b[j] + e * p.sb[j];
      const bool kc = (B_KC >> j) & 1;
      for (int idx = tid; idx < BN * BK; idx += THREADS) {
        const int n = kc ? idx / BK : idx % BN, k = kc ? idx % BK : idx / BN;
        const int gn = n0 + n, gk = k0 + k;
        Bs[j][k][n] = (gn < N && gk < K)
                          ? to_f(b[kc ? (int64_t)gn * p.ldb[j] + gk : (int64_t)gk * p.ldb[j] + gn])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[NA][TM];
#pragma unroll
      for (int t = 0; t < NA; ++t)
#pragma unroll
        for (int i = 0; i < TM; ++i) av[t][i] = As[t][k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int ta = (A1_OF >> j) & 1;
        float bv[TN];
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) bv[jj] = Bs[j][k][tx + jj * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) acc[j][i][jj] = fmaf(av[ta][i], bv[jj], acc[j][i][jj]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int row = m0 + ty * TM + i, col = n0 + tx + jj * TX;
      if (row < M && col < N) {
        float v[NACC];
#pragma unroll
        for (int j = 0; j < NACC; ++j) v[j] = acc[j][i][jj];
        store_epi<T, EPI, NACC>(p, ((int64_t)e * M + row) * N + col, v);
      }
    }
}

}  // namespace ffma

template <typename T, bool MMA, int NA, int NACC, bool A_KC, int B_KC, int A1_OF, int EPI>
cudaError_t run_pass(const Args<T>& p, int E, cudaStream_t s) {
  const dim3 grid((p.N + 63) / 64, (p.M + 63) / 64, E);
  if constexpr (MMA) {
    constexpr int smem = tc::smem_bytes<NA, NACC>();
    auto kernel = tc::gemm_kernel<NA, NACC, A_KC, B_KC, A1_OF, EPI>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::THREADS, smem, s>>>(p);
  } else {
    ffma::gemm_kernel<T, NA, NACC, A_KC, B_KC, A1_OF, EPI><<<grid, ffma::THREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, bool MMA>
cudaError_t passes(const void* x_, const void* wg_, const void* wu_, const void* wd_, const void* dy_, void* h_,
                   void* dg_, void* du_, void* dx_, void* dwg_, void* dwu_, void* dwd_, int E, int C, int D, int F,
                   cudaStream_t s) {
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  const T *x = in(x_), *wg = in(wg_), *wu = in(wu_), *wd = in(wd_), *dy = in(dy_);
  T *h = out(h_), *dg = out(dg_), *du = out(du_);
  const int64_t sCD = (int64_t)C * D, sDF = (int64_t)D * F, sCF = (int64_t)C * F;
  cudaError_t err;
  // 1. g = x.Wg, u = x.Wu, dH = dY.Wd^T (C x F over D) -> h, dG, dU
  Args<T> p1 = {{x, dy}, {sCD, sCD}, {D, D}, {wg, wu, wd}, {sDF, sDF, sDF}, {F, F, D}, {h, dg, du}, C, F, D};
  if ((err = run_pass<T, MMA, 2, 3, true, 0b100, 0b100, EPI_GATED>(p1, E, s)) != cudaSuccess) return err;
  // 2. dWd = h^T.dY (F x D over C)
  Args<T> p2 = {{h, nullptr}, {sCF, 0}, {F, 0}, {dy, nullptr, nullptr}, {sCD, 0, 0}, {D, 0, 0},
                {out(dwd_), nullptr, nullptr}, F, D, C};
  if ((err = run_pass<T, MMA, 1, 1, false, 0, 0, EPI_ONE>(p2, E, s)) != cudaSuccess) return err;
  // 3. dX = dG.Wg^T + dU.Wu^T (C x D over F, twice)
  Args<T> p3 = {{dg, du}, {sCF, sCF}, {F, F}, {wg, wu, nullptr}, {sDF, sDF, 0}, {F, F, 0},
                {out(dx_), nullptr, nullptr}, C, D, F};
  if ((err = run_pass<T, MMA, 2, 2, true, 0b11, 0b10, EPI_SUM>(p3, E, s)) != cudaSuccess) return err;
  // 4. dWg = x^T.dG, dWu = x^T.dU (D x F over C)
  Args<T> p4 = {{x, nullptr}, {sCD, 0}, {D, 0}, {dg, du, nullptr}, {sCF, sCF, 0}, {F, F, 0},
                {out(dwg_), out(dwu_), nullptr}, D, F, C};
  return run_pass<T, MMA, 1, 2, false, 0, 0, EPI_PAIR>(p4, E, s);
}

}  // namespace bwd

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 fma, 1 wgmma, 2 swap_ab (see the
// note above; the wrapper's _route picks it). h is (E, C, F) scratch in x's
// dtype. Launches the two passes on `stream`; returns the first non-zero
// cudaError_t, or cudaErrorInvalidValue for a route these shapes cannot take.
extern "C" int moe_gmm_fwd(const void* x, const void* w_gate, const void* w_up, const void* w_down, void* h,
                           void* out, int dtype, int route, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || (C + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_FMA) {
    if (dtype == 0) return (int)dispatch_c<float>(x, w_gate, w_up, w_down, h, out, E, C, D, F, s);
    if (dtype == 1) return (int)dispatch_c<__nv_bfloat16>(x, w_gate, w_up, w_down, h, out, E, C, D, F, s);
    return (int)cudaErrorInvalidValue;
  }
  // the tensor-core routes: bf16, 16-byte rows and 16-byte aligned bases
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)w_gate | (uintptr_t)w_up | (uintptr_t)w_down |
                          (uintptr_t)h | (uintptr_t)out;
  if (dtype != 1 || D % 8 || F % 8 || (bases & 15)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (route == ROUTE_WGMMA) {
    err = wg::launch<true>(x, w_gate, w_up, h, E, C, F, D, s);
    if (err != cudaSuccess) return (int)err;
    return (int)wg::launch<false>(h, w_down, nullptr, out, E, C, D, F, s);
  }
  if (route == ROUTE_SWAP_AB) {
    if (C > 8) return (int)cudaErrorInvalidValue;
    err = swab::launch<true>(x, w_gate, w_up, h, E, C, F, D, s);
    if (err != cudaSuccess) return (int)err;
    return (int)swab::launch<false>(h, w_down, nullptr, out, E, C, D, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of moe_gmm_fwd: dx (E, C, D), dwg and dwu (E, D, F), dwd
// (E, F, D) from x, the weights and dy (E, C, D), all in one dtype (0 =
// float32, 1 = bfloat16). h, dg and du are (E, C, F) scratch in that dtype;
// dh (E, C, F) f32 scratch for route BWD_WGMMA (the others take null).
// route: BWD_FMA, BWD_WGMMA or BWD_MMA (both bf16 with D and F multiples of 8
// and 16-byte aligned bases; the wrapper's _bwd_route picks fma or wgmma, mma
// is the earlier design, kept as a baseline). Launches the four passes on
// `stream`; returns the first non-zero cudaError_t, or cudaErrorInvalidValue
// for a route these inputs cannot take.
extern "C" int moe_gmm_bwd(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                           const void* dy, void* h, void* dg, void* du, void* dh, void* dx, void* dwg, void* dwu,
                           void* dwd, int dtype, int route, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || (C + 63) / 64 > 65535 || (D + 63) / 64 > 65535 ||
      (F + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == BWD_FMA && dtype == 0)
    return (int)bwd::passes<float, false>(x, w_gate, w_up, w_down, dy, h, dg, du, dx, dwg, dwu, dwd, E, C, D, F, s);
  if (route == BWD_FMA && dtype == 1)
    return (int)bwd::passes<__nv_bfloat16, false>(x, w_gate, w_up, w_down, dy, h, dg, du, dx, dwg, dwu, dwd, E, C,
                                                  D, F, s);
  // the tensor-core routes: bf16, 16-byte rows and 16-byte aligned bases
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)w_gate | (uintptr_t)w_up | (uintptr_t)w_down | (uintptr_t)dy |
                          (uintptr_t)h | (uintptr_t)dg | (uintptr_t)du;
  if (dtype != 1 || D % 8 || F % 8 || (bases & 15)) return (int)cudaErrorInvalidValue;
  if (route == BWD_WGMMA) {
    if (dh == nullptr || ((uintptr_t)dh & 15)) return (int)cudaErrorInvalidValue;
    return (int)wg::bwd_passes(x, w_gate, w_up, w_down, dy, h, dg, du, static_cast<float*>(dh), dx, dwg, dwu, dwd, E,
                               C, D, F, s);
  }
  if (route == BWD_MMA)
    return (int)bwd::passes<__nv_bfloat16, true>(x, w_gate, w_up, w_down, dy, h, dg, du, dx, dwg, dwu, dwd, E, C,
                                                 D, F, s);
  return (int)cudaErrorInvalidValue;
}
