"""Build the port's CUDA kernels with ``nvcc``, load them with ``ctypes``,
and check and launch a lane-major batch.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  ``csrc/bitboard.cu``, the board format and random bits the
kernels share, is included by them with ``#include "bitboard.cu"`` and never
built alone.  The library lands in ``gobblet_rl_torch/_build/`` under a name
keyed on a hash of its source, the ``csrc`` files it includes and the flags,
so an edit of any of them rebuilds and an unchanged tree is reused.  Nothing
builds when the module is imported: :func:`load` builds at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(src: Path) -> list[Path]:
    """``src`` and every file it includes with ``#include "..."``, directly
    or through another, each once, in the order they are first met."""
    found = [src]
    for path in found:  # grows while it is walked
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc not in found:
                found.append(inc)
    return found


def build(name: str) -> tuple[Path, str]:
    """Build ``csrc/<name>.cu`` unless it is built already.  Returns the
    library's path and the compiler's output (ptxas registers and spills;
    empty when reused).  Raises with that output if the build fails."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(src))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name)[0]))


def check_batch(board: torch.Tensor, current: torch.Tensor) -> int:
    """B of a lane-major batch (board int8[3, 9, B], mover int32[B], both
    contiguous on one device); raises ValueError otherwise."""
    if board.dtype != torch.int8 or board.dim() != 3 or board.shape[:2] != (3, 9):
        raise ValueError(f"board must be int8[3, 9, B], got {board.dtype} {tuple(board.shape)}")
    batch = board.shape[-1]
    if current.dtype != torch.int32 or tuple(current.shape) != (batch,):
        raise ValueError(f"current must be int32[{batch}], got {current.dtype} "
                         f"{tuple(current.shape)}")
    if current.device != board.device:
        raise ValueError("board and current must be on one device")
    if not (board.is_contiguous() and current.is_contiguous()):
        raise ValueError("board and current must be contiguous")
    return batch


_C_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint}


@functools.cache
def _entry(name: str, signature: str) -> ctypes._CFuncPtr:
    fn = getattr(load(name), f"gobblet_{name}_launch")
    fn.argtypes = [_C_TYPES[c] for c in signature] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, what: str, signature: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` through its C entry point
    ``gobblet_<name>_launch(*args, stream)`` on ``device``'s current stream.
    ``signature`` has one letter an argument: ``p`` a pointer (a tensor,
    passed as its data pointer, or None), ``i`` an int, ``u`` an unsigned
    int.  The entry point returns ``cudaGetLastError()``; a non-zero one
    raises RuntimeError naming the ``what`` kernel."""
    fn = _entry(name, signature)
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*values, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
