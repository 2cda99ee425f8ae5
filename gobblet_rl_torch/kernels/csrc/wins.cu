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
//  1. One thread per lane; plane k of the board is read at k * n + lane, so
//     a warp reads 32 neighbouring bytes of each plane (coalesced).
//  2. The legal mask as bitboards, as in draw.cu: the occupancy of every
//     level and the mover's ids 1+k, 3+k, 5+k (k = 0, 1) packed at bit
//     offsets 0, 10 and 20 of three words; free cells per level minus the
//     mover's covered ids, folded into one 54-bit word, bit a for action a
//     (piece a / 9 + 1 onto cell a % 9).
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

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 10;  // bit offset between levels in a packed word
constexpr uint32_t kCells = 0x1FFu | (0x1FFu << kStride) | (0x1FFu << 2 * kStride);
constexpr uint32_t kGuards = kCells + (0x001u | (0x001u << kStride) | (0x001u << 2 * kStride));

// Line i of core/types.py::WIN_LINES_NP, in its order, as a 9-bit cell mask
// (a function, not an array: device code may not index a constexpr array).
__host__ __device__ constexpr uint32_t win_line(int i) {
  switch (i) {
    case 0: return 0x007u;  // (0, 1, 2)
    case 1: return 0x038u;  // (3, 4, 5)
    case 2: return 0x1C0u;  // (6, 7, 8)
    case 3: return 0x049u;  // (0, 3, 6)
    case 4: return 0x092u;  // (1, 4, 7)
    case 5: return 0x124u;  // (2, 5, 8)
    case 6: return 0x111u;  // (0, 4, 8)
    default: return 0x054u;  // (2, 4, 6)
  }
}

// Fields of `x` (10 bits apart) that are non-zero become 0x1FF, others 0.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  const uint32_t h = (x + kCells) & kGuards;
  return h - (h >> 9);
}

// Bit i set where line i is full in the 9-bit mask `m`.
__device__ __forceinline__ uint32_t full_lines(uint32_t m) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) out |= (m & win_line(i)) == win_line(i) ? 1u << i : 0u;
  return out;
}

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

  // int8 board -> per-level masks of both signs, and the mover's ids packed
  // as draw.cu packs them
  const int sign = cur[lane] == 0 ? 1 : -1;
  uint32_t own[3] = {0, 0, 0}, opp[3] = {0, 0, 0};
  uint32_t occ = 0, a0 = 0, a1 = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int v = board[static_cast<size_t>(l * 9 + c) * n + lane] * sign;
      own[l] |= v > 0 ? 1u << c : 0u;
      opp[l] |= v < 0 ? 1u << c : 0u;
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

#pragma unroll
  for (int p = 0; p < 6; ++p) {  // piece id p + 1, on level p / 2
    const int l = p >> 1;
    const uint32_t at = ((p & 1 ? a1 : a0) >> (kStride * l)) & 0x1FFu;
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
