// Uniform draw of a legal action for a lane-major env batch, NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package draws a legal action as the
// argmax of a [54, B] Gumbel field under the legal mask, which XLA fuses on
// the TPU; eager PyTorch instead runs the mask (about 20 int8 launches),
// the field (rand, clamp, log, neg, log, neg over [54, B] float32), a where
// and an argmax, about 6 GB of device-memory traffic at B = 2,097,152 for 4
// bytes of output per env.  The DQN collect draws so 54 times an
// iteration (the random opponent's replies and openings, the actor's
// exploration), so this kernel computes the same distribution from the
// board in registers.
//
// What bounds it on this card: memory.  A call reads 27 board bytes and
// the 4-byte mover and writes the 4-byte action per env, 35 B, once; the
// work per env is one Philox block plus a few dozen word operations, far
// below what the SMs issue in the time the bytes take.  Design:
//
//  1. One thread per env; plane k of the board is read at k * n + env, so
//     a warp reads 32 neighbouring bytes of each plane (coalesced).
//  2. The legal mask as bitboards, as in rollout.cu: for the mover, word
//     k holds the 9-cell masks of piece ids 1+k, 3+k and 5+k at bit
//     offsets 0, 10 and 20 (id 2l+1+k lives on level l); the occupancy of
//     every level and what covers it are a handful of word operations, the
//     same as ops/batched_core.py::legal_mask_planes (`flat == 0 || size >
//     top_size`, minus the mover's covered ids).  The two words fold into
//     one 54-bit word, bit a for action a (piece a / 9 + 1 onto cell a % 9).
//  3. One Philox4x32-10 block per env: key (key[0] low, key[0] high),
//     counter (env, 0, key[1] low, key[1] high), where `key` is two int64
//     words the wrapper draws from the caller's torch.Generator on the
//     device at every call (no host synchronisation).  Its first two words
//     make a 64-bit draw u = y:x.
//  4. With n the number of legal actions, r = floor(u * n / 2^64) (the high
//     word of the 64-bit product), and the action is the r-th set bit of
//     the mask counted from bit 0, found by halving the word with popcounts
//     (six selects, no loop).  Each action gets floor(2^64 / n) or one more
//     of the 2^64 draws: the bias is at most n / 2^64.  No legal action
//     (n = 0) gives action 0, as the argmax over an all -inf field does.
// kernels/draw.py::random_legal_actions_plain computes the same action
// from the same two words with tensor code, bit for bit.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 10;  // bit offset between levels in a word
constexpr uint32_t kCells = 0x1FFu | (0x1FFu << kStride) | (0x1FFu << 2 * kStride);
constexpr uint32_t kGuards = kCells + (0x001u | (0x001u << kStride) | (0x001u << 2 * kStride));

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

struct Words {
  uint32_t x, y, z, w;
};

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds, key bumped between them.
__device__ __forceinline__ Words philox4x32_10(Words c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = Words{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// Fields of `x` (10 bits apart) that are non-zero become 0x1FF, others 0.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  const uint32_t h = (x + kCells) & kGuards;
  return h - (h >> 9);
}

// Position of the r-th set bit (from 0) of `m`; r < popcount(m).
__device__ __forceinline__ int nth_set_bit(uint64_t m, uint32_t r) {
  uint32_t w = static_cast<uint32_t>(m);
  int base = 0;
  uint32_t c = __popc(w);
  if (r >= c) {
    r -= c;
    w = static_cast<uint32_t>(m >> 32);
    base = 32;
  }
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    c = __popc(w & ((1u << half) - 1u));
    if (r >= c) {
      r -= c;
      w >>= half;
      base += half;
    }
  }
  return base;
}

__global__ void __launch_bounds__(kThreads)
draw_kernel(const int8_t* __restrict__ board, const int32_t* __restrict__ cur,
            const int64_t* __restrict__ key, int32_t* __restrict__ out, int n) {
  const int env = blockIdx.x * kThreads + threadIdx.x;
  if (env >= n) return;

  // int8 board -> occupancy and the mover's two words
  const int sign = cur[env] == 0 ? 1 : -1;
  uint32_t occ = 0, a0 = 0, a1 = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int v = board[static_cast<size_t>(l * 9 + c) * n + env] * sign;
      const uint32_t bit = 1u << (kStride * l + c);
      occ |= v != 0 ? bit : 0u;
      a0 |= v == 2 * l + 1 ? bit : 0u;
      a1 |= v == 2 * l + 2 ? bit : 0u;
    }
  }

  // legal actions: free cells per level, minus the mover's covered ids
  const uint32_t above = (occ >> kStride) | (occ >> 2 * kStride);
  const uint32_t free = ~(occ | above) & kCells;
  const uint32_t leg0 = free & ~spread(a0 & above);
  const uint32_t leg1 = free & ~spread(a1 & above);
  uint64_t mask = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    mask |= static_cast<uint64_t>((leg0 >> (kStride * l)) & 0x1FFu) << (18 * l);
    mask |= static_cast<uint64_t>((leg1 >> (kStride * l)) & 0x1FFu) << (18 * l + 9);
  }

  // one Philox block: a 64-bit draw, scaled to an index among the legal
  const uint64_t k = static_cast<uint64_t>(key[0]), ctr = static_cast<uint64_t>(key[1]);
  const Words r = philox4x32_10(
      Words{static_cast<uint32_t>(env), 0u, static_cast<uint32_t>(ctr),
            static_cast<uint32_t>(ctr >> 32)},
      static_cast<uint32_t>(k), static_cast<uint32_t>(k >> 32));
  const uint64_t u = (static_cast<uint64_t>(r.y) << 32) | r.x;
  const uint32_t legal = __popcll(mask);
  const uint32_t index = static_cast<uint32_t>(__umul64hi(u, legal));
  out[env] = legal == 0 ? 0 : nth_set_bit(mask, index);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `key`
// points to two int64 words on the device.
extern "C" int gobblet_draw_launch(const void* board, const void* cur, const void* key, void* out,
                                   int n, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  draw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), static_cast<const int32_t*>(cur),
      static_cast<const int64_t*>(key), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
