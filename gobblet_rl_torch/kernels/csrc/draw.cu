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
//  1. One thread per env, reading the board as bitboard.cu lays it out.
//  2. The legal mask from bitboard.cu's words (the mover's two and the
//     occupancy), folded into one 54-bit word, bit a for action a.
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

#include <cuda_runtime.h>

#include "bitboard.cu"

namespace {

constexpr int kThreads = 256;

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

  // int8 board -> the mover's words; the legal actions as a 54-bit word
  const Mover m = load_mover(board, n, env, cur[env]);
  Legal leg;
  legal_set(m, leg);
  const uint64_t mask = action_mask(leg);

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
