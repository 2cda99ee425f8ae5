// Fused random-admissible self-play rollout for NVIDIA Hopper (sm_90a).
//
// Replaces gobblet_rl_tpu/ops/pallas_rollout.py::_rollout_kernel (the
// pl.pallas_call of rollout_random_pallas).  The function is the same:
// num_steps plies per env of (1) legal mask, (2) uniform choice over the
// legal set as the max of 24-bit draws with the lowest index winning ties,
// (3) lift + place, (4) last-line-wins winner fold over the topmost-piece
// view, (5) episode / P1-win / P2-win counts and auto-reset to an empty
// board with player 0 to move.  The TPU kernel's blocks are not carried
// over: here one thread owns one env for all plies.
//
// What bounds it on this card: integer instruction issue, not memory.  A
// call reads and writes 31 B per env once, while each ply runs several
// hundred 32-bit integer instructions (chip_smoke.py counts them in the
// built code, per ply, and divides by the SMs' integer rate).  The kernel
// can only go faster by executing fewer instructions per env-ply:
//
//  1. Bitboards (bitboard.cu has the format).  An env's state is four
//     words, two for the player to move (A) and two for the other (B), so
//     the legal set is a handful of word operations and placement
//     overwrites one field with `1 << cell`.  The int8 board is converted
//     with selects at the start and the end only.  The mover's and the
//     other's words swap every ply, so nothing selects on the player to
//     move.
//  2. Winner from line masks.  Each player's topmost-piece mask indexes a
//     512-entry table in shared memory (built by the block at start) that
//     gives its 8-bit mask of completed lines, bit i for WIN_LINES[i].  The
//     two masks share no bit, so "the last matching line decides" is the
//     larger mask (eight line tests in registers measured slower).
//  3. One max over packed keys.  Action a's key is (draw << 8) | (255 -
//     code(a)), code = 64*level + 32*k + cell, which rises with a; the
//     largest legal key is the largest draw with the lowest index on ties,
//     and its low byte names the piece and the cell.  An illegal action's
//     key is zeroed by an all-ones-or-zero mask (one PRMT from the legal
//     word) and the keys fold in pairs with Hopper's three-way DPX max
//     __vimax3_u32 (a max under `if (legal)` compiles to compares and
//     selects per action and measured slower).  Shifting a draw up by 8
//     drops the neighbouring draw's bits for free.
//  4. 11 Philox4x32-10 blocks a ply, counter (ply, block, 0, 0) and key
//     (seed, env): each 128-bit block gives five 24-bit draws at bit offsets
//     0, 24, 48, 72 and 96 (__funnelshift_r across word boundaries).
//  5. __launch_bounds__(256, 4): at most 64 registers, four blocks (32
//     warps) an SM, no spills (three and five blocks measured within the
//     spread between runs); the episode counts add up per thread in two
//     registers (P2 wins are episodes minus P1 wins).
// Stats reduce within each warp by shuffles, then across the block in
// shared memory, then one 64-bit atomicAdd per counter per block.  Field
// mode reads pre-drawn uint32[num_steps, 54, B] words (draw = word >> 8) in
// place of Philox (the parity tests); the selection rule is the same.

#include <cuda_runtime.h>

#include "bitboard.cu"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks per SM: at most 64 registers a thread
constexpr int kActions = 54;
constexpr int kDraws = 5;    // 24-bit draws per Philox block
constexpr int kChunks = 11;  // Philox blocks per ply: 55 draws >= 54 actions

// Draw j (24 bits at bit 24*j of the block) shifted to bits 8..31.
__device__ __forceinline__ uint32_t draw_hi(const Words& r, int j) {
  switch (j) {
    case 0: return r.x << 8;
    case 1: return __funnelshift_r(r.x, r.y, 24) << 8;
    case 2: return __funnelshift_r(r.y, r.z, 16) << 8;
    case 3: return r.z & 0xFFFFFF00u;
    default: return r.w << 8;
  }
}

// All ones if bit `b` (a constant after unrolling) of `v` is set, else 0:
// shift the bit to the top of a byte, then one PRMT replicates that byte's
// sign over the word.
__device__ __forceinline__ uint32_t bit_mask(uint32_t v, int b) {
  const int s = (7 - b % 8 + 8) % 8;
  uint32_t m;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(m) : "r"(v << s), "r"(0x8888u | 0x1111u * ((b + s) / 8)));
  return m;
}

// The 9-bit mask of cells whose topmost piece is in `own` (levels packed).
__device__ __forceinline__ uint32_t top_cells(uint32_t own, uint32_t above) {
  const uint32_t vis = own & ~above;
  return (vis | (vis >> kStride) | (vis >> 2 * kStride)) & 0x1FFu;
}

template <bool kField>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rollout_kernel(const int8_t* __restrict__ board_in, const int32_t* __restrict__ cur_in,
               int8_t* __restrict__ board_out, int32_t* __restrict__ cur_out,
               unsigned long long* __restrict__ stats, const uint32_t* __restrict__ field,
               int n, int num_steps, uint32_t seed) {
  const int env = blockIdx.x * kThreads + threadIdx.x;
  __shared__ uint8_t lines[512];
  for (int m = threadIdx.x; m < 512; m += kThreads) lines[m] = static_cast<uint8_t>(full_lines(m));
  __syncthreads();
  int eps = 0, w1 = 0;

  if (env < n) {
    // int8 board -> X and O words
    uint32_t x0 = 0, x1 = 0, o0 = 0, o1 = 0;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const int v = board_in[static_cast<size_t>(l * 9 + c) * n + env];
        const uint32_t bit = 1u << (kStride * l + c);
        x0 |= v == 2 * l + 1 ? bit : 0u;
        x1 |= v == 2 * l + 2 ? bit : 0u;
        o0 |= v == -(2 * l + 1) ? bit : 0u;
        o1 |= v == -(2 * l + 2) ? bit : 0u;
      }
    }
    int cur = cur_in[env];
    uint32_t a0 = cur == 0 ? x0 : o0, a1 = cur == 0 ? x1 : o1;  // player to move
    uint32_t b0 = cur == 0 ? o0 : x0, b1 = cur == 0 ? o1 : x1;  // the other

#pragma unroll 1
    for (int t = 0; t < num_steps; ++t) {
      // legal actions: free cells per level, minus the mover's frozen ids
      Legal leg;
      legal_set(Mover{a0 | a1 | b0 | b1, a0, a1}, leg);

      // one max over the packed keys of the legal actions
      uint32_t best = 0, pending = 0;
#pragma unroll
      for (int chunk = 0; chunk < kChunks; ++chunk) {
        Words r{0u, 0u, 0u, 0u};
        if constexpr (!kField) {
          r = philox4x32_10(Words{static_cast<uint32_t>(t), static_cast<uint32_t>(chunk), 0u, 0u},
                            seed, static_cast<uint32_t>(env));
        }
#pragma unroll
        for (int j = 0; j < kDraws; ++j) {
          const int a = chunk * kDraws + j;
          if (a < kActions) {
            const int l = a / 18, k = (a / 9) % 2, cell = a % 9;
            uint32_t hi;
            if constexpr (kField) {
              hi = field[(static_cast<size_t>(t) * kActions + a) * n + env] & 0xFFFFFF00u;
            } else {
              hi = draw_hi(r, j);
            }
            const uint32_t key = hi | (255u - (64u * l + 32u * k + cell));
            const uint32_t gated = key & bit_mask(k ? leg.leg1 : leg.leg0, kStride * l + cell);
            if (a % 2 == 0) {
              pending = gated;
            } else {
              best = __vimax3_u32(best, pending, gated);
            }
          }
        }
      }

      // lift + place: the chosen id's field becomes the target cell
      const uint32_t code = ~best & 0xFFu;
      const uint32_t l = code >> 6, cell = code & 31u;
      const uint32_t clear = ~(0x1FFu << (kStride * l)), bit = 1u << (kStride * l + cell);
      if (code & 32u) {
        a1 = (a1 & clear) | bit;
      } else {
        a0 = (a0 & clear) | bit;
      }

      // winner: compare the two players' completed-line masks
      const uint32_t own_a = a0 | a1, own_b = b0 | b1;
      const uint32_t occ2 = own_a | own_b;
      const uint32_t above2 = (occ2 >> kStride) | (occ2 >> 2 * kStride);
      const uint32_t la = lines[top_cells(own_a, above2)], lb = lines[top_cells(own_b, above2)];
      const bool done = (la | lb) != 0;
      eps += done;
      w1 += done && ((la > lb) == (cur == 0));

      // the other player moves next; a finished game restarts empty, P1 first
      const uint32_t na0 = a0, na1 = a1;
      a0 = done ? 0u : b0;
      a1 = done ? 0u : b1;
      b0 = done ? 0u : na0;
      b1 = done ? 0u : na1;
      cur = done ? 0 : 1 - cur;
    }

    // X and O words -> int8 board
    x0 = cur == 0 ? a0 : b0;
    x1 = cur == 0 ? a1 : b1;
    o0 = cur == 0 ? b0 : a0;
    o1 = cur == 0 ? b1 : a1;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const int s = kStride * l + c;
        const int v = (x0 >> s) & 1u   ? 2 * l + 1
                      : (x1 >> s) & 1u ? 2 * l + 2
                      : (o0 >> s) & 1u ? -(2 * l + 1)
                      : (o1 >> s) & 1u ? -(2 * l + 2)
                                       : 0;
        board_out[static_cast<size_t>(l * 9 + c) * n + env] = static_cast<int8_t>(v);
      }
    }
    cur_out[env] = cur;
  }

  // every thread of the block reaches the reduction, in range or not
  int w2 = eps - w1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    eps += __shfl_down_sync(0xffffffffu, eps, o);
    w1 += __shfl_down_sync(0xffffffffu, w1, o);
    w2 += __shfl_down_sync(0xffffffffu, w2, o);
  }
  __shared__ int partial[3][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    partial[0][warp] = eps;
    partial[1][warp] = w1;
    partial[2][warp] = w2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s0 += partial[0][w];
      s1 += partial[1][w];
      s2 += partial[2][w];
    }
    atomicAdd(&stats[0], s0);
    atomicAdd(&stats[1], s1);
    atomicAdd(&stats[2], s2);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `field`
// is null for Philox mode.  `stats` must hold three zeroed int64 counters.
extern "C" int gobblet_rollout_launch(const void* board_in, const void* cur_in, void* board_out,
                                      void* cur_out, void* stats, const void* field, int n,
                                      int num_steps, unsigned int seed, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bi = static_cast<const int8_t*>(board_in);
  const auto* ci = static_cast<const int32_t*>(cur_in);
  auto* bo = static_cast<int8_t*>(board_out);
  auto* co = static_cast<int32_t*>(cur_out);
  auto* st = static_cast<unsigned long long*>(stats);
  const auto* f = static_cast<const uint32_t*>(field);
  if (f != nullptr) {
    rollout_kernel<true><<<grid, kThreads, 0, s>>>(bi, ci, bo, co, st, f, n, num_steps, seed);
  } else {
    rollout_kernel<false><<<grid, kThreads, 0, s>>>(bi, ci, bo, co, st, f, n, num_steps, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the field-mode (`field_mode` != 0) or Philox
// kernel on the current device, or -1 if the runtime cannot say.
extern "C" int gobblet_rollout_blocks_per_sm(int field_mode) {
  int blocks = -1;
  const cudaError_t err =
      field_mode ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rollout_kernel<true>,
                                                                 kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rollout_kernel<false>,
                                                                 kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}
