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
// What bounds it on this card: integer ALU, not memory.  A call reads and
// writes 31 B per env (27-byte board + int32 player) once, while each ply
// spends about 1,760 integer operations: ~850 on 14 Philox4x32-10 blocks
// (54 draws) and ~900 on the 54-action mask, placement and win fold
// (itemised in chip_smoke.py).
//
// What the simple design does about it:
//  * the board lives in 27 registers for the whole call, so device memory
//    is touched only at the start and the end (coalesced: env is the
//    fastest axis of every array);
//  * nothing is indexed by a runtime value: placement is an unrolled select
//    over the 27 cells, the 54 actions fold into a running (max, index)
//    pair in an unrolled loop with no per-action array, and the frozen
//    pieces are a bitmask -- so nothing spills to local memory;
//  * the random bits are Philox4x32-10 keyed on (seed, env) with counter
//    (ply, chunk), computed in registers (no state, no memory traffic);
//  * one thread per env and 256 threads per block give 2048 blocks at the
//    full-width batch, enough to fill all SMs; the ragged edge is masked;
//  * stats reduce within each warp by shuffles, then across the block in
//    shared memory, then one 64-bit atomicAdd per counter per block.
// Field mode reads pre-drawn uint32[num_steps, 54, B] words in place of
// Philox (the parity tests); the selection rule is the same.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kActions = 54;
constexpr int kChunks = 14;  // Philox blocks per ply: 4 words each, 56 >= 54

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

__device__ __forceinline__ uint32_t word(const Words& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// One win line of the fold: a matching line overwrites the running winner,
// so the LAST matching line in reference order decides.
__device__ __forceinline__ int fold_line(int w, int a, int b, int c) {
  const int lw = int(a > 0 && b > 0 && c > 0) - int(a < 0 && b < 0 && c < 0);
  return lw != 0 ? lw : w;
}

__device__ __forceinline__ int top_piece(const int* b, int c) {
  return b[18 + c] != 0 ? b[18 + c] : (b[9 + c] != 0 ? b[9 + c] : b[c]);
}

template <bool kField>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const int8_t* __restrict__ board_in, const int32_t* __restrict__ cur_in,
               int8_t* __restrict__ board_out, int32_t* __restrict__ cur_out,
               unsigned long long* __restrict__ stats, const uint32_t* __restrict__ field,
               int n, int num_steps, uint32_t seed) {
  const int env = blockIdx.x * kThreads + threadIdx.x;
  int eps = 0, w1 = 0, w2 = 0;

  if (env < n) {
    int b[27];  // level-major: b[level * 9 + cell]
#pragma unroll
    for (int i = 0; i < 27; ++i) b[i] = board_in[static_cast<size_t>(i) * n + env];
    int cur = cur_in[env];

    for (int t = 0; t < num_steps; ++t) {
      const int sign = cur == 0 ? 1 : -1;

      // topmost piece and its size per cell; frozen own pieces as bits 1..6
      int top[9], top_size[9];
      uint32_t frozen = 0;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        top[c] = top_piece(b, c);
        top_size[c] = (abs(top[c]) + 1) >> 1;
        const int v0 = b[c] * sign, v1 = b[9 + c] * sign;
        const bool cov0 = b[c] != 0 && (b[9 + c] != 0 || b[18 + c] != 0);
        const bool cov1 = b[9 + c] != 0 && b[18 + c] != 0;
        if (cov0 && (v0 == 1 || v0 == 2)) frozen |= 1u << v0;
        if (cov1 && (v1 == 3 || v1 == 4)) frozen |= 1u << v1;
      }

      // fold the 54 actions into the running (max draw, lowest index)
      int best = -1, best_a = 99;
#pragma unroll
      for (int chunk = 0; chunk < kChunks; ++chunk) {
        Words r{0u, 0u, 0u, 0u};
        if constexpr (!kField) {
          r = philox4x32_10(Words{static_cast<uint32_t>(t), static_cast<uint32_t>(chunk), 0u, 0u},
                            seed, static_cast<uint32_t>(env));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = chunk * 4 + j;
          if (a < kActions) {
            const int pos = a % 9, piece = a / 9 + 1, size = (piece + 1) >> 1;
            const bool legal = (top[pos] == 0 || size > top_size[pos]) &&
                               !((frozen >> piece) & 1u);
            uint32_t bits;
            if constexpr (kField) {
              bits = field[(static_cast<size_t>(t) * kActions + a) * n + env];
            } else {
              bits = word(r, j);
            }
            const int draw = legal ? static_cast<int>(bits >> 8) : -1;
            if (draw > best) {
              best = draw;
              best_a = a;
            }
          }
        }
      }

      // lift the moving piece from wherever it was, place it at the target
      const int piece = best_a / 9 + 1;
      const int target = (((piece + 1) >> 1) - 1) * 9 + best_a % 9;
      const int moved = piece * sign;
#pragma unroll
      for (int i = 0; i < 27; ++i) b[i] = i == target ? moved : (b[i] == moved ? 0 : b[i]);

#pragma unroll
      for (int c = 0; c < 9; ++c) top[c] = top_piece(b, c);
      int win = 0;
      win = fold_line(win, top[0], top[1], top[2]);
      win = fold_line(win, top[3], top[4], top[5]);
      win = fold_line(win, top[6], top[7], top[8]);
      win = fold_line(win, top[0], top[3], top[6]);
      win = fold_line(win, top[1], top[4], top[7]);
      win = fold_line(win, top[2], top[5], top[8]);
      win = fold_line(win, top[0], top[4], top[8]);
      win = fold_line(win, top[2], top[4], top[6]);

      const bool done = win != 0;
      eps += done;
      w1 += win == 1;
      w2 += win == -1;
#pragma unroll
      for (int i = 0; i < 27; ++i) b[i] = done ? 0 : b[i];
      cur = done ? 0 : 1 - cur;
    }

#pragma unroll
    for (int i = 0; i < 27; ++i) board_out[static_cast<size_t>(i) * n + env] = static_cast<int8_t>(b[i]);
    cur_out[env] = cur;
  }

  // every thread of the block reaches the reduction, in range or not
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
