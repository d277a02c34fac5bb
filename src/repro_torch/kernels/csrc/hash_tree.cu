// Blockwise tree-hash states of card-resident payloads, k at a time, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_tree.py::hash_tree_state
// (body _hash_tree_kernel), and the host finish of the ragged rest that went
// with it. A payload of n bytes is read as little-endian uint32 words in
// 128-word (512-byte) blocks; a last partial block and a 0..3-byte tail
// (packed little-endian into one more word) form one more block
// j = floor(n / 512). For block j:
//   s_j = sum of its words                   (uint32, wraparound)
//   c_j = (j * 0x9E3779B1 + 0x85EBCA77) | 1
//   m_j = (s_j ^ c_j) * c_j                  (uint32, wraparound)
// and the payload's state is (sum m_j, xor m_j, sum s_j) mod 2^32, written
// to out[3 p .. 3 p + 2] for payload p of the launch.
//
// What bounds it on this card: bytes. Each word is read once for about one
// integer operation, and 12 bytes a payload are written, so the floor is
// (n + 12) bytes a payload over the memory rate (0.32 ms for 1 GiB, 0.090 ms
// for a wave of 64 payloads of 4.5 MiB, at 3.35 TB/s).
//
// What the design does:
//   * One launch takes up to MAX_PAYLOADS payloads, whose (pointer, bytes,
//     first CTA) table is passed by value as a __grid_constant__ kernel
//     parameter (2.6 KB, under the 4 KB limit): no table is copied to the
//     card. The grid is sized to the card (SMs x CTAS_PER_SM, the SM count
//     cached by the caller), and each payload gets CTAs in proportion to
//     its blocks, at least one and no more than its blocks fill: one
//     4.5 MiB payload, a wave of 64 and one 1 GiB payload all fill the SMs.
//     A CTA finds its payload by a binary search over the first-CTA column.
//   * Inside a payload, one warp takes one block at a time: 32 lanes x one
//     16-byte streaming load (__ldcs) = 128 words. The block sum is finished
//     with __shfl_xor_sync, and lane 0 keeps the warp's running state in
//     registers through a grid-stride loop over the payload's blocks; each
//     warp issues the loads of UNROLL blocks before it reduces any. The warp
//     whose stride reaches block floor(n / 512) also folds the partial block
//     and the tail, with 4-byte and 1-byte loads that stop at n bytes.
//   * No output is zeroed by the caller and nothing is filled: each CTA
//     writes its partial state to its own slot of a scratch array, then
//     takes a ticket from its payload's counter (atomicInc, which wraps to 0
//     at the payload's CTA count). The CTA that draws the last ticket has
//     seen every other partial written (__threadfence before each ticket),
//     reduces them and writes the payload's 3 words; the counter is back at
//     0 for the next launch. A payload with one CTA writes its state
//     directly. (Chosen over a cooperative launch with a grid-wide sync:
//     that needs every CTA resident at once and holds all SMs idle while
//     the last payload's blocks finish; the ticket needs neither.)
//   * Two launches on different streams stay apart because the caller keeps
//     one scratch and ticket array per (device, stream); launches on one
//     stream run in order. The three folds are associative and commutative
//     mod 2^32, so the result is exact and does not depend on the order in
//     which CTAs finish.
//   * The grid is one wave: __launch_bounds__(THREADS, CTAS_PER_SM) holds a
//     thread to 32 registers, so 8 CTAs fit an SM (unbounded, the compiler
//     took 38, 6 CTAs fit, and the last third of the grid ran as a second
//     wave: +2% at 1 GiB, +1.9 us at 4.5 MiB).
//   * j is the block's index in its payload as uint32, where wraparound is
//     defined, as the reference's uint32 arithmetic wraps.
//   * The Pallas kernel's sequential chunk grid has no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;        // blocks loaded ahead by each warp
constexpr int CTAS_PER_SM = 8;   // 8 x 256 threads fill an SM's 2048
constexpr int MAX_PAYLOADS = 128;
constexpr int BLOCK_BYTES = 512;
constexpr uint32_t GOLD = 0x9E3779B1u;
constexpr uint32_t SALT = 0x85EBCA77u;

struct Table {
  const unsigned char* ptr[MAX_PAYLOADS];  // 16-byte aligned
  long long nbytes[MAX_PAYLOADS];
  int first[MAX_PAYLOADS + 1];  // first CTA of each payload; first[k] = the grid
  int k;
};

struct State {
  uint32_t a, x, s;  // (sum m, xor m, sum s)
};

__device__ __forceinline__ void combine(State& st, const State& o) {
  st.a += o.a;
  st.x ^= o.x;
  st.s += o.s;
}

// finish a block from each lane's share of its sum: every lane holds s_j
__device__ __forceinline__ void mix(uint32_t s, uint32_t j, State& st) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const uint32_t c = (j * GOLD + SALT) | 1u;
  const uint32_t m = (s ^ c) * c;
  st.a += m;
  st.x ^= m;
  st.s += s;
}

__device__ __forceinline__ void fold(const uint4 v, uint32_t j, State& st) {
  mix(v.x + v.y + v.z + v.w, j, st);
}

// the partial block j at p (128 - 1 or fewer words, then 0..3 tail bytes):
// lane l takes words 4l .. 4l + 3, and the word at n_words the tail bytes
__device__ __forceinline__ void fold_partial(const unsigned char* p, int n_words, int n_tail,
                                             uint32_t j, int lane, State& st) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane * 4 + i;
    if (idx < n_words) {
      s += __ldcs(w + idx);
    } else if (idx == n_words) {
      for (int q = 0; q < n_tail; ++q) s += (uint32_t)p[4 * idx + q] << (8 * q);
    }
  }
  mix(s, j, st);
}

// the CTA's state, summed over its warps' lane-0 states, in thread 0
__device__ State reduce_cta(State st, int lane, int warp) {
  __shared__ State warp_state[WARPS];
  if (lane == 0) warp_state[warp] = st;
  __syncthreads();
  State r = {0u, 0u, 0u};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) combine(r, warp_state[w]);
  }
  return r;
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)  // <= 32 registers: 8 CTAs an SM
hash_tree_kernel(const __grid_constant__ Table t, uint32_t* __restrict__ part,
                 unsigned int* __restrict__ tickets, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cta = blockIdx.x;
  int p = 0;
  for (int hi = t.k; hi - p > 1;) {  // the last payload whose first CTA is <= cta
    const int mid = (p + hi) / 2;
    if (t.first[mid] <= cta) p = mid;
    else hi = mid;
  }
  const int first = t.first[p], n_ctas = t.first[p + 1] - first;
  const long long n = t.nbytes[p];
  const int64_t n_blocks = n / BLOCK_BYTES;  // full blocks
  const uint4* words = reinterpret_cast<const uint4*>(t.ptr[p]);

  const int64_t stride = (int64_t)n_ctas * WARPS;
  State st = {0u, 0u, 0u};
  int64_t b = (int64_t)(cta - first) * WARPS + warp;
  for (; b + (UNROLL - 1) * stride < n_blocks; b += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(words + (b + u * stride) * 32 + lane);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fold(v[u], (uint32_t)(b + u * stride), st);
  }
  for (; b < n_blocks; b += stride) fold(__ldcs(words + b * 32 + lane), (uint32_t)b, st);
  // b is now this warp's first index past the full blocks: one warp's is n_blocks
  const int rest = (int)(n % BLOCK_BYTES);
  if (b == n_blocks && rest)
    fold_partial(t.ptr[p] + n_blocks * BLOCK_BYTES, rest / 4, rest % 4, (uint32_t)n_blocks, lane, st);

  const State mine = reduce_cta(st, lane, warp);
  if (n_ctas == 1) {
    if (threadIdx.x == 0) {
      out[3 * p] = mine.a;
      out[3 * p + 1] = mine.x;
      out[3 * p + 2] = mine.s;
    }
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part[3 * cta] = mine.a;
    part[3 * cta + 1] = mine.x;
    part[3 * cta + 2] = mine.s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicInc(tickets + p, (unsigned)(n_ctas - 1)) == (unsigned)(n_ctas - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other CTA's partial, fenced before its ticket, is seen
  State r = {0u, 0u, 0u};
#pragma unroll 4
  for (int i = threadIdx.x; i < n_ctas; i += THREADS) {  // loads of several partials in flight
    const uint32_t* q = part + 3 * (first + i);
    combine(r, State{__ldcg(q), __ldcg(q + 1), __ldcg(q + 2)});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r.a += __shfl_xor_sync(0xffffffffu, r.a, o);
    r.x ^= __shfl_xor_sync(0xffffffffu, r.x, o);
    r.s += __shfl_xor_sync(0xffffffffu, r.s, o);
  }
  const State sum = reduce_cta(r, lane, warp);
  if (threadIdx.x == 0) {
    out[3 * p] = sum.a;
    out[3 * p + 1] = sum.x;
    out[3 * p + 2] = sum.s;
  }
}

}  // namespace

// Words of scratch (partial states) a launch on a card of `sms` SMs needs; the
// caller also keeps MAX_PAYLOADS ticket counters, zeroed once, per stream.
extern "C" long long hash_tree_scratch_words(int sms) {
  return 3LL * ((long long)sms * CTAS_PER_SM + MAX_PAYLOADS);
}

extern "C" int hash_tree_max_payloads() { return MAX_PAYLOADS; }

// Tree states of k payloads (1 <= k <= MAX_PAYLOADS): ptrs[i] (16-byte
// aligned unless nbytes[i] is 0) holds nbytes[i] bytes; out: 3 k uint32,
// written in full; part: hash_tree_scratch_words(sms) uint32, any contents;
// tickets: MAX_PAYLOADS uint32, zero before the launch and after it. One
// launch on `stream`. Returns the launch's cudaError_t (0 on success).
extern "C" int hash_tree_batch(const void* const* ptrs, const long long* nbytes, int k, void* out,
                               void* part, void* tickets, int sms, void* stream) {
  if (k < 1 || k > MAX_PAYLOADS || sms < 1) return (int)cudaErrorInvalidValue;
  Table t;
  t.k = k;
  long long total = 0;
  for (int i = 0; i < k; ++i) {
    if (nbytes[i] < 0 || (nbytes[i] && (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) != 0))
      return (int)cudaErrorInvalidValue;
    t.ptr[i] = static_cast<const unsigned char*>(ptrs[i]);
    t.nbytes[i] = nbytes[i];
    total += (nbytes[i] + BLOCK_BYTES - 1) / BLOCK_BYTES;
  }
  // CTAs in proportion to blocks, at least 1, at most what the blocks fill
  const long long budget = (long long)sms * CTAS_PER_SM;
  t.first[0] = 0;
  for (int i = 0; i < k; ++i) {
    const long long blocks = (nbytes[i] + BLOCK_BYTES - 1) / BLOCK_BYTES;
    const long long fill = (blocks + WARPS - 1) / WARPS;
    long long c = total ? budget * blocks / total : 1;
    c = c < fill ? c : fill;
    c = c > 1 ? c : 1;
    t.first[i + 1] = t.first[i] + (int)c;
  }
  hash_tree_kernel<<<t.first[k], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<uint32_t*>(part), static_cast<unsigned int*>(tickets),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
