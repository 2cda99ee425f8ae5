// One-move win check for a lane-major board batch, NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package checks the 54 actions of every
// lane with one engine call over a folded 54·B lane axis, which XLA fuses
// into one pass on the TPU.  Eager PyTorch runs the same call as about 60
// launches: it tiles the board 54 times (int8[3, 9, 54·B], 764 MB at
// B = 524,288), places each action, takes the top pieces and folds the
// eight lines, each launch writing and rereading hundreds of MB, for 54
// bools a lane.  The Gumbel search runs this check at every expansion and
// at the final pick, 33 times a search, so this kernel computes the same
// bools from the board in registers.
//
// What bounds it on this card: memory, for the function.  A call reads 27
// board bytes and the 4-byte mover and writes 54 bools a lane, 85 B, once:
// 44.6 MB, or 0.0133 ms at 3.35 TB/s, at B = 524,288.  The code a lane runs,
// six lifts and 54 placements of a few word operations each (about 1,900
// machine instructions), takes about four times as long at the SMs' issue
// rate, so the kernel is issue-bound, at a small fraction of the tensor
// code's time.  The design keeps every intermediate in registers, so the
// bytes stay at their least:
//
//  1. One thread per lane, reading the board as bitboard.cu lays it out.
//  2. The legal mask from bitboard.cu's words (the mover's two and the
//     occupancy), folded into one 54-bit word, bit a for action a.
//  3. The mover's and the opponent's pieces as 9-bit masks per level.  For
//     each piece p (ids are level-unique, so p stands on level (p - 1) / 2
//     or in hand), lift it: clear its cell on its level, and the top of each
//     cell is again the highest piece left.  Then t_own and t_opp, the cells
//     whose top is the mover's or the opponent's, and their full lines as
//     8-bit words, bit i for line i of core/types.py::WIN_LINES_NP.
//  4. For each target cell c of p: a legal placement puts p above whatever
//     stands on c (c is empty or its top is smaller, and c is not p's own
//     cell), so after the move the mover owns the top of c and the opponent
//     loses it.  The opponent keeps its full lines that miss c; the mover
//     gains each line through c whose two other cells it tops.
//  5. The last matching line decides the winner, of either sign.  A cell's
//     top has one owner, so no line is full for both; the last full line is
//     the mover's exactly when the mover's line word is the larger number.
//     A lift can reveal an opponent's line after the mover's, and then the
//     move does not win although it completes a line.
//  6. Row a of the output is written at a * n + lane (coalesced); an illegal
//     action writes false.
// kernels/wins.py::winning_actions_plain computes the same bools with the
// engine's tensor code, bit for bit.

#include <cuda_runtime.h>

#include "bitboard.cu"

namespace {

constexpr int kThreads = 256;

// The lines through cell `c` as bits i of line i.
__host__ __device__ constexpr uint32_t lines_through(int c) {
  uint32_t out = 0;
  for (int i = 0; i < 8; ++i) out |= (win_line(i) >> c & 1u) << i;
  return out;
}

// Full lines of `t | 1 << c`, given `full` = full_lines(t): the lines
// through c whose two other cells `t` holds join them.
__device__ __forceinline__ uint32_t full_lines_with(uint32_t t, uint32_t full, int c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t rest = win_line(i) & ~(1u << c);
    if (win_line(i) >> c & 1u) full |= (t & rest) == rest ? 1u << i : 0u;
  }
  return full;
}

__global__ void __launch_bounds__(kThreads)
wins_kernel(const int8_t* __restrict__ board, const int32_t* __restrict__ cur,
            bool* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;

  // int8 board -> the mover's words, and per-level masks of both signs
  uint32_t own[3] = {0, 0, 0}, opp[3] = {0, 0, 0};
  const Mover m = load_mover(board, n, lane, cur[lane], [&](int l, int c, int v) {
    own[l] |= v > 0 ? 1u << c : 0u;
    opp[l] |= v < 0 ? 1u << c : 0u;
  });
  Legal leg;
  legal_set(m, leg);
  const uint64_t mask = action_mask(leg);

#pragma unroll
  for (int p = 0; p < 6; ++p) {  // piece id p + 1, on level p / 2
    const int l = p >> 1;
    const uint32_t at = ((p & 1 ? m.a1 : m.a0) >> (kStride * l)) & 0x1FFu;
    uint32_t o[3] = {own[0], own[1], own[2]};
    o[l] &= ~at;
    const uint32_t occ2 = o[2] | opp[2];
    const uint32_t occ12 = occ2 | o[1] | opp[1];
    const uint32_t t_own = o[2] | (o[1] & ~occ2) | (o[0] & ~occ12);
    const uint32_t t_opp = opp[2] | (opp[1] & ~occ2) | (opp[0] & ~occ12);
    const uint32_t full_own = full_lines(t_own), full_opp = full_lines(t_opp);
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int a = 9 * p + c;
      const uint32_t mine = full_lines_with(t_own, full_own, c);
      const uint32_t theirs = full_opp & ~lines_through(c);
      out[static_cast<size_t>(a) * n + lane] = (mask >> a & 1u) && mine > theirs;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `out` is
// bool[54, n], one byte an element.
extern "C" int gobblet_wins_launch(const void* board, const void* cur, void* out, int n,
                                   void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  wins_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), static_cast<const int32_t*>(cur),
      static_cast<bool*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
