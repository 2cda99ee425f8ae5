"""The SASS reader of chip_smoke.py on a listing in cuobjdump's format: the
main loop of the named kernel is the span from a backward branch to its
target; a loop-free kernel counts its whole body.  cuobjdump itself runs only where the CUDA toolkit is, beside the
card."""

import importlib.util
import subprocess
import types
from pathlib import Path

import pytest

from gobblet_rl_torch.kernels import build

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN4anon14rollout_kernelILb0EEEvPKa
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/               @P0 BRA 0x90 ;                      /* 0x0000008000400947 */
        /*0020*/                   IMAD.WIDE.U32 R4, R3, -0x2daee0ad, RZ ;
        /*0030*/                   LOP3.LUT R5, R4, R6, R7, 0x96, !PT ;
        /*0040*/                   NOP ;
        /*0050*/                   VIMNMX3.U32 R8, R8, R5, R4, !PT ;
        /*0060*/                   ISETP.GE.AND P1, PT, R9, UR4, PT ;
        /*0070*/              @!P1 BRA 0x20 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
\t\tFunction : _ZN4anon14rollout_kernelILb1EEEvPKa
        /*0000*/                   SHF.R.U32.HI R1, RZ, 0x8, R2 ;
        /*0010*/               @P0 BRA 0x0 ;
"""


def _fake_cuobjdump(monkeypatch, listing):
    monkeypatch.setattr(build, "nvcc", lambda: "/toolkit/bin/nvcc")
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=listing)

    monkeypatch.setattr(subprocess, "run", run)
    return calls


@pytest.fixture
def listing(monkeypatch):
    return _fake_cuobjdump(monkeypatch, LISTING)


def test_sass_functions_reads_each_kernel(listing):
    funcs = chip_smoke.sass_functions(Path("lib.so"))
    assert listing == [["/toolkit/bin/cuobjdump", "-sass", "lib.so"]]
    assert [len(v) for v in funcs.values()] == [10, 2]
    assert funcs["_ZN4anon14rollout_kernelILb0EEEvPKa"][1] == (0x10, "BRA", " 0x90 ")


def test_sass_loop_counts_the_largest_backward_span(listing):
    loop = chip_smoke.sass_loop(Path("lib.so"), "rollout_kernelILb0E")
    # 0x20..0x70 without the NOP; the forward branch and the self-loop at
    # the end are not the main loop
    assert loop["instructions"] == 5
    assert loop["opcodes"] == {"IMAD": 1, "LOP3": 1, "VIMNMX3": 1, "ISETP": 1, "BRA": 1}
    with pytest.raises(RuntimeError):
        chip_smoke.sass_loop(Path("lib.so"), "rollout_kernel")  # two kernels match
    n, alu, _ = chip_smoke.sass_counts(Path("lib.so"))
    assert (n, alu) == (5, 2)  # LOP3 and ISETP run on the integer ALU pipe


def test_sass_loop_refuses_a_branch_inside_the_loop(monkeypatch):
    inner = LISTING.replace("NOP ;", "@P2 BRA 0x60 ;")
    _fake_cuobjdump(monkeypatch, inner)
    with pytest.raises(RuntimeError, match="2 branches"):
        chip_smoke.sass_loop(Path("lib.so"), "rollout_kernelILb0E")


def test_sass_counts_without_cuobjdump_is_none_and_parse_faults_raise(monkeypatch):
    monkeypatch.setattr(build, "nvcc", lambda: "/toolkit/bin/nvcc")

    def missing(cmd, **kwargs):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "run", missing)
    assert chip_smoke.sass_counts(Path("lib.so")) is None
    _fake_cuobjdump(monkeypatch, LISTING.replace("@!P1 BRA 0x20", "@!P1 BRA 0x80"))
    with pytest.raises(RuntimeError, match="no loop"):
        chip_smoke.sass_counts(Path("lib.so"))


def test_sass_body_counts_a_whole_kernel(listing):
    """The draw kernel has no loop: every instruction of its body counts,
    but ``NOP``."""
    body = chip_smoke.sass_body(Path("lib.so"), "rollout_kernelILb1E")
    assert body["instructions"] == 2 and body["opcodes"] == {"SHF": 1, "BRA": 1}
    assert chip_smoke.sass_body(Path("lib.so"), "rollout_kernelILb0E")["instructions"] == 9
    with pytest.raises(RuntimeError):
        chip_smoke.sass_body(Path("lib.so"), "rollout_kernel")  # two kernels match


def test_build_keys_on_the_files_a_source_includes(tmp_path, monkeypatch):
    """An edit of a file that a kernel source includes changes that kernel's
    library, and an edit of a file it does not include leaves it.  A fake
    ``nvcc`` writes an empty library; no card or toolkit is needed."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "shared.cu").write_text("#pragma once\nconstexpr int kA = 1;\n")
    (csrc / "other.cu").write_text("constexpr int kB = 2;\n")
    (csrc / "kernel.cu").write_text('#include <cstdint>\n#include "shared.cu"\n')
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))

    first, _ = build.build("kernel")
    assert first.exists() and build.build("kernel")[0] == first
    (csrc / "other.cu").write_text("constexpr int kB = 3;\n")
    assert build.build("kernel")[0] == first
    (csrc / "shared.cu").write_text("#pragma once\nconstexpr int kA = 2;\n")
    second, _ = build.build("kernel")
    assert second != first and second.exists()
