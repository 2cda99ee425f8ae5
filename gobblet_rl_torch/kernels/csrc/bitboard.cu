// The packed-bitboard board format and the random bits that the port's CUDA
// kernels (rollout.cu, draw.cu, wins.cu) share.  Each kernel includes this
// file; it is never built alone.
//
// A batch is lane-major: the int8 board [3, 9, B] holds plane 9 * l + c
// (level l, cell c) of lane e at (9 * l + c) * n + e, so with one thread a
// lane a warp reads 32 neighbouring bytes of each plane (coalesced).  Piece
// id 2l+1+k (k = 0, 1) lives on level l, positive for player 0 and negative
// for player 1.
//
// In registers a player's pieces are two words: word k holds the 9-cell
// masks of ids 1+k, 3+k and 5+k at bit offsets 0, 10 and 20 (bit 9 of each
// field is a guard).  The OR of both players' words is every level's
// occupancy at once, and one shift pair gives what covers each level, so the
// free cells for every size and the covered pieces are a handful of word
// operations, the same as ops/batched_core.py::legal_mask_planes (`flat == 0
// || size > top_size`, minus the mover's covered ids).  No array is indexed
// by a runtime value.  Action a moves piece a / 9 + 1 onto cell a % 9; the
// 54-bit action mask holds it at bit a.
#pragma once

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kStride = 10;  // bit offset between levels in a word
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

// Bit i set where line i is full in the 9-bit mask `m`.
__device__ __forceinline__ uint32_t full_lines(uint32_t m) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) out |= (m & win_line(i)) == win_line(i) ? 1u << i : 0u;
  return out;
}

// Fields of `x` (10 bits apart) that are non-zero become 0x1FF, others 0.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  const uint32_t h = (x + kCells) & kGuards;
  return h - (h >> 9);
}

// The mover's legal targets, one word per k as its own words: free cells
// per level (empty and not covered), minus the fields of its covered ids.
struct Legal {
  uint32_t leg0, leg1;
};

// The 54-bit action mask of `leg`: bit a for action a.
__device__ __forceinline__ uint64_t action_mask(const Legal& leg) {
  uint64_t mask = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    mask |= static_cast<uint64_t>((leg.leg0 >> (kStride * l)) & 0x1FFu) << (18 * l);
    mask |= static_cast<uint64_t>((leg.leg1 >> (kStride * l)) & 0x1FFu) << (18 * l + 9);
  }
  return mask;
}

// Every level's occupancy and the mover's two words.
struct Mover {
  uint32_t occ, a0, a1;
};

// The legal targets of the mover of `m`, into `leg`.  This form (a Mover by
// value, an out-parameter) and action_mask's const reference are the ones
// under which nvcc compiles draw.cu and rollout.cu to the same machine code as
// the step written out in each kernel; a returned struct costs draw_kernel 16
// instructions.
__device__ __forceinline__ void legal_set(Mover m, Legal& leg) {
  const uint32_t above = (m.occ >> kStride) | (m.occ >> 2 * kStride);
  const uint32_t free = ~(m.occ | above) & kCells;
  leg.leg0 = free & ~spread(m.a0 & above);
  leg.leg1 = free & ~spread(m.a1 & above);
}

struct NoVisit {
  __device__ void operator()(int, int, int) const {}
};

// Lane `e` of `board` as the mover `cur` sees it (its own pieces positive).
// `visit(l, c, v)` is handed each cell's sign-relative value as it is read,
// for a kernel that keeps more of the board than the words.
template <typename Visit = NoVisit>
__device__ __forceinline__ Mover load_mover(const int8_t* __restrict__ board, int n, int e,
                                            int cur, Visit visit = {}) {
  const int sign = cur == 0 ? 1 : -1;
  Mover m{0u, 0u, 0u};
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int v = board[static_cast<size_t>(l * 9 + c) * n + e] * sign;
      visit(l, c, v);
      const uint32_t bit = 1u << (kStride * l + c);
      m.occ |= v != 0 ? bit : 0u;
      m.a0 |= v == 2 * l + 1 ? bit : 0u;
      m.a1 |= v == 2 * l + 2 ? bit : 0u;
    }
  }
  return m;
}

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

}  // namespace
