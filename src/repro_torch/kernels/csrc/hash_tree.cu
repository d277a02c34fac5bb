// Blockwise tree-hash state of a card-resident payload, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_tree.py::hash_tree_state
// (body _hash_tree_kernel). The payload is a word array of n uint32 (n a
// non-zero multiple of 8192), cut into 128-word (512-byte) blocks. For block j:
//   s_j = sum of its 128 words               (uint32, wraparound)
//   c_j = (j * 0x9E3779B1 + 0x85EBCA77) | 1
//   m_j = (s_j ^ c_j) * c_j                  (uint32, wraparound)
// and the state is (sum m_j, xor m_j, sum s_j) mod 2^32, written to out[0..2].
//
// What bounds it on this card: bytes. Each word is read once for about one
// integer operation, and the result is 12 bytes, so the floor is 4n bytes over
// the memory rate (0.32 ms for 1 GiB at 3.35 TB/s).
//
// What the design does:
//   * One warp takes one block at a time: 32 lanes x one 16-byte load = 128
//     words. The block sum s_j is finished with __shfl_xor_sync, so every
//     lane holds it, and lane 0 keeps the warp's running (sum m, xor m, sum s)
//     in registers. A grid-stride loop walks the blocks; each warp issues the
//     loads of UNROLL blocks before it reduces any, to keep bytes in flight.
//   * The Pallas kernel carries its state in VMEM across a grid that runs in
//     order. Blocks here run in no order, so each CTA reduces its warps'
//     partials in shared memory and adds them to the zeroed 3-word output with
//     one atomicAdd, one atomicXor and one atomicAdd. The three operations are
//     associative and commutative mod 2^32: the result is exact and does not
//     depend on the order in which CTAs finish.
//   * j is the block's index in the array as uint32, where wraparound is
//     defined, as the reference's uint32 arithmetic wraps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;        // blocks loaded ahead by each warp
constexpr int CTAS_PER_SM = 8;   // 8 x 256 threads fill an SM's 2048
constexpr uint32_t GOLD = 0x9E3779B1u;
constexpr uint32_t SALT = 0x85EBCA77u;

__device__ __forceinline__ void fold(const uint4 v, uint32_t j, uint32_t& h1, uint32_t& h2,
                                     uint32_t& h3) {
  uint32_t s = v.x + v.y + v.z + v.w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const uint32_t c = (j * GOLD + SALT) | 1u;
  const uint32_t m = (s ^ c) * c;
  h1 += m;
  h2 ^= m;
  h3 += s;
}

__global__ void __launch_bounds__(THREADS)
hash_tree_kernel(const uint4* __restrict__ words, int64_t n_blocks, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  uint32_t h1 = 0, h2 = 0, h3 = 0;
  int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  for (; b + (UNROLL - 1) * stride < n_blocks; b += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(words + (b + u * stride) * 32 + lane);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fold(v[u], (uint32_t)(b + u * stride), h1, h2, h3);
  }
  for (; b < n_blocks; b += stride) fold(__ldcs(words + b * 32 + lane), (uint32_t)b, h1, h2, h3);

  __shared__ uint32_t part[3][WARPS];
  if (lane == 0) {
    part[0][warp] = h1;
    part[1][warp] = h2;
    part[2][warp] = h3;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a = 0, x = 0, s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += part[0][w];
      x ^= part[1][w];
      s += part[2][w];
    }
    atomicAdd(out, a);
    atomicXor(out + 1, x);
    atomicAdd(out + 2, s);
  }
}

}  // namespace

// words: n_words uint32, 16-byte aligned, n_words a non-zero multiple of 128;
// out: 3 uint32, zeroed by the caller on the same stream. Returns the launch's
// cudaError_t (0 on success).
extern "C" int hash_tree_fwd(const void* words, long long n_words, void* out, void* stream) {
  if (n_words <= 0 || n_words % 128 != 0 || (reinterpret_cast<uintptr_t>(words) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_blocks = n_words / 128;
  const int64_t want = (n_blocks + WARPS - 1) / WARPS;
  const int grid = (int)(want < (int64_t)sms * CTAS_PER_SM ? want : (int64_t)sms * CTAS_PER_SM);
  hash_tree_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), n_blocks, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
