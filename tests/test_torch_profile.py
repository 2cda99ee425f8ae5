"""``profile_dqn`` of the port: its trace reduction on a hand-written
Chrome trace (totals worked out by hand), its kernel classes, and the
command line on the CPU, whose summary has the JAX script's keys but
``prng``."""

import json
import re
from pathlib import Path

import pytest
import torch

from gobblet_rl_torch.scripts import profile_dqn

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def op(name, ts, dur, tid=1, cat="cpu_op", pid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


# thread 1: linear [0, 100) holds addmm [10, 60) (which holds a copy
# [20, 30)) and a copy [70, 90); where [150, 180) after it.  Thread 2: a
# copy [5, 45), overlapping thread 1 in time but on its own stack.  Two
# kernels on stream 7, one on stream 13 beside them, a memcpy, a memset;
# an annotation, a runtime call and a flow event that no table reads.
TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    op("aten::linear", 0, 100), op("aten::addmm", 10, 50), op("aten::copy_", 20, 10),
    op("aten::copy_", 70, 20), op("aten::where", 150, 30), op("aten::copy_", 5, 40, tid=2),
    op("ProfilerStep#0", 0, 200, cat="user_annotation"),
    op("cudaLaunchKernel", 12, 3, cat="cuda_runtime"),
    op("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 30, 12.5, tid=7, cat="kernel", pid=0),
    op("void at::native::vectorized_elementwise_kernel<4, add>", 50, 3, tid=7, cat="kernel", pid=0),
    op("void at::native::vectorized_elementwise_kernel<4, add>", 51, 4, tid=13, cat="kernel",
       pid=0),
    op("Memcpy HtoD (Pageable -> Device)", 60, 2, tid=7, cat="gpu_memcpy", pid=0),
    op("Memset (Device)", 65, 1, tid=7, cat="gpu_memset", pid=0),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 1, "ts": 12, "id": 1},
]}


@pytest.fixture
def trace_file(tmp_path):
    path = tmp_path / "trace-1-0.json"
    path.write_text(json.dumps(TRACE))
    return path


def test_cuda_table_sums_device_rows(trace_file):
    table = profile_dqn.device_op_table(trace_file, "cuda")
    assert table == [
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 12.5, 1),
        ("void at::native::vectorized_elementwise_kernel<4, add>", 7, 2),
        ("Memcpy HtoD (Pageable -> Device)", 2, 1),
        ("Memset (Device)", 1, 1),
    ]


def test_cpu_table_is_exclusive_time(trace_file):
    table = profile_dqn.device_op_table(trace_file, torch.device("cpu"))
    # copy: 10 + 20 on thread 1, 40 on thread 2; linear: 100 - 50 - 20;
    # addmm: 50 - 10; where: 30
    assert table == [("aten::copy_", 70, 3), ("aten::addmm", 40, 1),
                     ("aten::linear", 30, 1), ("aten::where", 30, 1)]
    assert sum(us for _, us, _ in table) == 170   # the threads' busy time, once


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn>",
     "matmul"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_bias_TNN", "matmul"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float>",
     "rng"),
    ("void at::native::vectorized_elementwise_kernel<4, direct_copy_kernel_cuda>", "data-movement"),
    ("Memcpy DtoD (Device -> Device)", "data-movement"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "data-movement"),
    ("void at::native::bitonicSortKVInPlace<int>", "sort"),
    ("void at::native::sbtopk::gatherTopK<float>", "sort"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather-scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>", "gather-scatter"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, MaxOps>>", "reduce-fusion"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", "fusion"),
    ("rollout_kernel<false>", "rollout-kernel"),
    ("aten::addmm", "matmul"),
    ("void gobblet_unnamed_kernel<int>", "other"),
])
def test_classify(name, cls):
    assert profile_dqn.classify(name) == cls


def jax_summary_keys() -> set:
    """The keys of the JAX script's summary dict, read from its source."""
    source = (REPO / "scripts" / "profile_dqn.py").read_text()
    body = source.split("summary = {", 1)[1].split("\n    }", 1)[0]
    return set(re.findall(r'^\s{8}"(\w+)":', body, re.M))


def test_cli_on_cpu(capsys, tmp_path):
    summary = profile_dqn.main(["--family", "dqn", "--envs", "64", "--iters", "1", "--device",
                                "cpu", "--top", "5", "--logdir", str(tmp_path),
                                "--json-out", str(tmp_path / "summary.json")])
    keys = jax_summary_keys()
    assert "prng" in keys and "module_ms_per_iter" in keys
    assert set(summary) == keys - {"prng"}
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: v for k, v in summary.items() if k != "top"}
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert summary["family"] == "dqn" and summary["envs"] == 64 and summary["iters"] == 1
    assert summary["module_ms_per_iter"] is None          # no card: no device time
    assert summary["device_total_ms"] > 0 and summary["wall_s"] > 0
    assert sum(summary["by_class_ms"].values()) == pytest.approx(summary["device_total_ms"],
                                                                 abs=1e-2)
    assert len(summary["top"]) == 5 and all(r["calls"] >= 1 for r in summary["top"])
    assert summary["env_steps_per_sec"] == pytest.approx(64 * 18 / summary["wall_s"], rel=1e-2)
    assert len(list(tmp_path.glob("trace-*.json"))) == 1


def test_cli_removes_the_trace_dir_it_made(monkeypatch, tmp_path, capsys):
    """Without ``--logdir`` the trace goes to a directory of its own, which
    is gone once the table is read; ``--logdir`` keeps it (above)."""
    made = tmp_path / "prof"

    def mkdtemp(prefix):
        made.mkdir()
        return str(made)

    monkeypatch.setattr(profile_dqn.tempfile, "mkdtemp", mkdtemp)
    summary = profile_dqn.main(["--family", "dqn", "--envs", "64", "--iters", "1",
                                "--device", "cpu", "--top", "1"])
    assert summary["device_total_ms"] > 0 and "prof" in capsys.readouterr().err
    assert not made.exists()


def test_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_dqn.main(["--family", "dqn", "--envs", "64", "--iters", "1"])
