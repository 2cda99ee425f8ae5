"""ctypes bindings of the native C++ rules engine and exact solver
(``csrc/gobblet.cpp``), for the torch port.

Port of the JAX package's ``native/engine.py``: the single-env
:class:`NativeEngine` (rules, greedy, random playouts, scripted matches
and the alpha-beta move) and the batch entry points :func:`solve`,
:func:`solve_tt_clear`, :func:`solve_batch` and :func:`alphabeta_batch`.
The port builds its own copy of the library: the
source compiles with ``g++`` (or ``$CXX``) and the flags of
``csrc/Makefile`` into ``gobblet_rl_torch/_build/``, under a name keyed on a
hash of the source, the compiler, the flags and what ``-march=native``
selects on the host, so an edited source (or another CPU) rebuilds and an
unchanged one is reused.  Nothing builds when the module is
imported: :func:`load` builds at first use, and a failed build raises with
the compiler's output.

Boards are ``int8[27]`` rows, level-major (level·9 + cell), the layout of
a lane-major ``[3, 9, B]`` batch transposed to ``[B, 3, 9]``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "gobblet.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def build() -> Path:
    """Build ``csrc/gobblet.cpp`` unless it is built already; returns the
    library's path.  Raises with the compiler's output if the build fails."""
    cxx = os.environ.get("CXX", "g++")
    # what -march=native means on this host: a library built for another
    # CPU is not reused
    arch = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((cxx, *CXXFLAGS, arch)).encode())
    target = BUILD_DIR / f"libgobblet-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32 = ctypes.POINTER(ctypes.c_int32)
    c_int, u64 = ctypes.c_int, ctypes.c_uint64
    batch = (None, [i8p, i32p, c_int, c_int, u64, i32p])
    signatures = {  # name: (restype, argtypes)
        "gob_reset": (None, [i8p]),
        "gob_legal_mask": (u64, [i8p, c_int]),
        "gob_is_legal": (c_int, [i8p, c_int, c_int]),
        "gob_apply": (None, [i8p, c_int, c_int]),
        "gob_winner": (c_int, [i8p]),
        "gob_greedy_action": (c_int, [i8p, c_int, c_int, ctypes.POINTER(u64)]),
        "gob_random_playout": (ctypes.c_long, [i8p, ctypes.POINTER(c_int), ctypes.c_long,
                                               u64, i8p]),
        "gob_play_match": (c_int, [c_int, c_int, c_int, u64, c_int, i8p]),
        "gob_alphabeta_action": (c_int, [i8p, c_int, c_int, u64]),
        "gob_play_match2": (c_int, [c_int, c_int, c_int, c_int, c_int, u64, c_int, i8p]),
        "gob_solve": (ctypes.c_long, [i8p, c_int, c_int, i32, i32, i32, i32]),
        "gob_solve_tt_clear": (None, []),
        "gob_solve_action": (c_int, [i8p, c_int, c_int, u64]),
        "gob_solve_batch": batch,
        "gob_alphabeta_batch": batch,
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        load()
        return True
    except Exception:
        return False


class NativeEngine:
    """Single-env engine over the C core; ``board`` is ``int8[27]``,
    level-major."""

    def __init__(self):
        self.lib = load()
        self.board = np.zeros(27, np.int8)
        self.rng_state = ctypes.c_uint64(0x9E3779B97F4A7C15)

    def seed(self, seed: int) -> None:
        self.rng_state = ctypes.c_uint64((seed << 1) | 1)

    def reset(self) -> None:
        self.lib.gob_reset(self.board)

    def legal_mask(self, player: int) -> np.ndarray:
        bits = int(self.lib.gob_legal_mask(self.board, player))
        return (bits >> np.arange(54)) & 1 == 1

    def is_legal(self, player: int, action: int) -> bool:
        return bool(self.lib.gob_is_legal(self.board, player, action))

    def apply(self, player: int, action: int) -> None:
        """Play ``action``; an illegal or out-of-range action changes nothing."""
        self.lib.gob_apply(self.board, player, action)

    def winner(self) -> int:
        return int(self.lib.gob_winner(self.board))

    def greedy_action(self, player: int, depth: int = 2) -> int:
        return int(self.lib.gob_greedy_action(self.board, player, depth,
                                              ctypes.byref(self.rng_state)))

    def random_playout(self, num_steps: int, seed: int = 1):
        """``num_steps`` random-admissible plies in native code, from the
        board with player 0 to move; ``(episodes, int8[num_steps] winners)``."""
        player = ctypes.c_int(0)
        winners = np.zeros(num_steps, np.int8)
        episodes = self.lib.gob_random_playout(self.board, ctypes.byref(player), num_steps,
                                               seed, winners)
        return int(episodes), winners

    def play_match(self, num_games: int, depth_p0: int, depth_p1: int, seed: int = 1,
                   max_plies: int = 200):
        """Greedy (depth 0: random) against greedy; ``(wins of player 0,
        int8[num_games] winners)``."""
        winners = np.zeros(num_games, np.int8)
        wins0 = self.lib.gob_play_match(num_games, depth_p0, depth_p1, seed, max_plies, winners)
        return int(wins0), winners

    def alphabeta_action(self, player: int, depth: int = 6, salt: int = 1) -> int:
        """Iterative-deepening alpha-beta move for the current board."""
        return int(self.lib.gob_alphabeta_action(self.board, player, depth, salt))

    def play_match2(self, num_games: int, kind_p0: int, depth_p0: int, kind_p1: int,
                    depth_p1: int, seed: int = 1, max_plies: int = 200):
        """Scripted-agent match; kind 0 is random, 1 greedy, 2 alpha-beta."""
        winners = np.zeros(num_games, np.int8)
        wins0 = self.lib.gob_play_match2(num_games, kind_p0, depth_p0, kind_p1, depth_p1, seed,
                                         max_plies, winners)
        return int(wins0), winners


def solve(board: np.ndarray | None = None, player: int = 0, max_depth: int = 30) -> dict:
    """Exact-solve a position (default: the opening).  Returns ``{move,
    score, proven, mate_in, depth, nodes}``; ``proven`` means the score is a
    forced win or loss within the horizon (mate scale ``|score| = 30000 -
    plies-to-mate``)."""
    lib = load()
    board = np.zeros(27, np.int8) if board is None else np.ascontiguousarray(board, np.int8)
    if board.size != 27:
        raise ValueError(f"a board has 27 cells, not {board.size}")
    move, score, proven, depth = (ctypes.c_int32() for _ in range(4))
    nodes = lib.gob_solve(board.reshape(27), player, max_depth, ctypes.byref(move),
                          ctypes.byref(score), ctypes.byref(proven), ctypes.byref(depth))
    s = int(score.value)
    return {
        "move": int(move.value),
        "score": s,
        "proven": bool(proven.value),
        "mate_in": (30000 - abs(s)) if abs(s) > 29000 else None,
        "depth": int(depth.value),
        "nodes": int(nodes),
    }


def solve_tt_clear() -> None:
    """Release the solver's transposition table (2 GiB once touched)."""
    if load.cache_info().currsize:
        load().gob_solve_tt_clear()


def _batch(fn_name: str, boards: np.ndarray, players: np.ndarray, depth: int,
           seed: int) -> np.ndarray:
    boards = np.ascontiguousarray(boards, np.int8).reshape(-1, 27)
    players = np.ascontiguousarray(players, np.int32)
    if players.shape != boards.shape[:1]:
        raise ValueError(f"{boards.shape[0]} boards but players of shape {players.shape}")
    out = np.zeros(boards.shape[0], np.int32)
    getattr(load(), fn_name)(boards, players, boards.shape[0], depth,
                             int(seed) & (2**64 - 1), out)
    return out


def solve_batch(boards: np.ndarray, players: np.ndarray, depth: int = 20,
                seed: int = 1) -> np.ndarray:
    """int32[n] exact-solver moves for ``boards`` int8[n, 27] with
    ``players`` int32[n] to move; the per-position salt (from ``seed``)
    varies only the choice among equally fast proven wins."""
    return _batch("gob_solve_batch", boards, players, depth, seed)


def alphabeta_batch(boards: np.ndarray, players: np.ndarray, depth: int = 6,
                    seed: int = 1) -> np.ndarray:
    """int32[n] iterative-deepening alpha-beta moves, the contract of
    :func:`solve_batch`."""
    return _batch("gob_alphabeta_batch", boards, players, depth, seed)
