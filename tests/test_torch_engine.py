"""Port parity: gobblet_rl_torch's tables and lane-major engine against
gobblet_rl_tpu.ops.batched_core, bit for bit on the CPU.

Inputs (action streams, noise fields) come from numpy seeds and go through
both frameworks; integer state is compared exactly.
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch.core import types as TT
from gobblet_rl_torch.device import resolve_device
from gobblet_rl_torch.models.mlp import QNet
from gobblet_rl_torch.ops import batched_core as tbc
from gobblet_rl_tpu.core import types as JT
from gobblet_rl_tpu.ops import batched_core as jbc

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def to_torch(state: jbc.PlanesState) -> tbc.PlanesState:
    return tbc.PlanesState(*(torch.from_numpy(np.array(x)) for x in state))


def assert_same(jstate, tstate, msg=""):
    for field, j, t in zip(jbc.PlanesState._fields, jstate, tstate):
        j = np.asarray(j)
        t = t.numpy()
        assert t.dtype == j.dtype, f"{field} dtype {t.dtype} != {j.dtype} {msg}"
        np.testing.assert_array_equal(t, j, err_msg=f"{field} {msg}")


def pick_actions(rng, mask_bf, illegal_every=0, step=0):
    """One numpy-chosen legal action per env (optionally some arbitrary)."""
    B = mask_bf.shape[0]
    actions = np.zeros(B, np.int32)
    for b in range(B):
        if illegal_every and step % 7 == 3 and b % illegal_every == 0:
            actions[b] = rng.integers(0, 54)
        else:
            actions[b] = rng.choice(np.nonzero(mask_bf[b])[0])
    return actions


def random_states(B=96, plies=9, seed=0):
    """Matching JAX/torch PlanesStates after numpy-chosen legal plies, with
    finished games reset (varied, reachable positions)."""
    rng = np.random.default_rng(seed)
    js = jbc.reset_planes(B)
    step = jax.jit(lambda s, a: jbc.autoreset_planes(jbc.step_planes(s, a)))
    mask_fn = jax.jit(jbc.legal_mask_planes)
    for _ in range(plies):
        mask = np.asarray(mask_fn(js.board, js.current)).T
        js = step(js, jnp.asarray(pick_actions(rng, mask)))
    return js, to_torch(js)


@pytest.mark.parametrize("name", [
    "NUM_CELLS", "NUM_LEVELS", "NUM_PIECES", "NUM_ACTIONS", "NUM_AGENTS", "OBS_CHANNELS",
    "ACTION_POS_NP", "ACTION_PIECE_NP", "ACTION_SIZE_NP", "ACTION_LEVEL_NP",
    "PIECE_SIZE_NP", "PIECE_LEVEL_NP", "WIN_LINES_NP",
])
def test_tables_equal_jax(name):
    t, j = getattr(TT, name), getattr(JT, name)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert np.asarray(t).dtype == np.asarray(j).dtype


def test_package_imports_no_jax():
    """Importing the whole port pulls in neither jax nor the JAX package,
    nor msgpack or orbax, which the card's machine lacks (a subprocess:
    this test process already imported them).  The framework adapters
    import under the stubs of ``tests/framework_stubs.py`` (tianshou and
    ray are not installed)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "from tests import framework_stubs\n"
        "framework_stubs.install_tianshou_stub()\n"
        "framework_stubs.install_rllib_stub()\n"
        "import gobblet_rl_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gobblet_rl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msgpack', 'gobblet_rl_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('gobblet_rl_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 70  # every module was imported


# the modules that run only on a host with pettingzoo, gymnasium, pygame or
# PIL (the AEC env, its renders and command lines, the manual policy), or
# with tianshou or ray (the adapters)
HOST_ONLY = ("gobblet_rl_torch.env.aec", "gobblet_rl_torch.gobblet_v1",
             "gobblet_rl_torch.render.surface", "gobblet_rl_torch.interactive.manual_policy",
             "gobblet_rl_torch.adapters.tianshou_adapter",
             "gobblet_rl_torch.adapters.rllib_adapter",
             "gobblet_rl_torch.examples.example_basic", "gobblet_rl_torch.examples.example_greedy",
             "gobblet_rl_torch.examples.example_record_game",
             "gobblet_rl_torch.examples.example_user_input",
             "gobblet_rl_torch.examples.main", "gobblet_rl_torch.examples.main_random",
             "gobblet_rl_torch.tutorials.tutorial_greedy",
             "gobblet_rl_torch.tutorials.tutorial_alphazero")


def test_card_path_needs_no_host_package():
    """With pettingzoo, gymnasium, pygame and PIL blocked (the card's
    machine has none of them), every module of the port but the host-only
    ones imports, and so does chip_smoke.py; the host-only ones do need
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('pettingzoo', 'gymnasium', 'pygame', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        f"host_only = {HOST_ONLY!r}\n"
        "import gobblet_rl_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'gobblet_rl_torch.')]\n"
        "assert set(host_only) <= set(names), names\n"
        "for name in names:\n"
        "    if name not in host_only:\n"
        "        importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert not [m for m in host_only if m in sys.modules]\n"
        "try:\n"
        "    importlib.import_module('gobblet_rl_torch.gobblet_v1')\n"
        "except ImportError:\n"
        "    print(len(names) - len(host_only))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 59


# the JAX package's native library, by path or by its build: the port
# builds and loads its own copy (gobblet_rl_torch/native/engine.py)
BORROWED_LIBRARY = re.compile(
    r"gobblet_rl_tpu\W{1,8}native|libgobblet\.so|make\W{1,4}-C|['\"]make['\"]\s*,\s*['\"]-C")


def test_source_scan_no_jax_imports():
    files = sorted((REPO / "gobblet_rl_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    # the repository's tools and tutorials are in the scan too
    for sub in ("scripts", "tutorials"):
        tools = [f for f in files if f.parent.name == sub]
        assert len(tools) >= (4 if sub == "scripts" else 3), sub
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|msgpack|gobblet_rl_tpu)\b", re.M)
    hits = [f"{f.name}: {m.group(0).strip()}" for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits
    borrowed = [f"{f.name}: {m.group(0)}" for f in files
                for m in BORROWED_LIBRARY.finditer(f.read_text())]
    assert not borrowed, borrowed
    for bad in ('ROOT / "gobblet_rl_tpu" / "native"', "gobblet_rl_tpu/native/libgobblet.so",
                'subprocess.run(["make", "-C", csrc])', "os.system('make -C csrc')"):
        assert BORROWED_LIBRARY.search(bad), bad
    assert len(files) >= 82


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            tbc.reset_planes(8)
        with pytest.raises(RuntimeError):
            QNet()
    assert resolve_device("cpu") == CPU


def test_device_cuda_string_means_the_card():
    """``--device cuda``, every command line's default, is checked as
    ``None`` is."""
    if torch.cuda.is_available():
        assert resolve_device("cuda") == resolve_device(None)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


def test_reset_planes_matches():
    assert_same(jbc.reset_planes(33), tbc.reset_planes(33, CPU))


def test_step_planes_matches_with_illegal_and_post_terminal_actions():
    """Both engines driven by one numpy action stream for many plies, with
    deliberately illegal actions and steps on finished (frozen) games."""
    B, S = 128, 48
    rng = np.random.default_rng(0)
    js, ts = jbc.reset_planes(B), tbc.reset_planes(B, CPU)
    step = jax.jit(jbc.step_planes)
    mask_fn = jax.jit(jbc.legal_mask_planes)
    for s in range(S):
        jm = np.asarray(mask_fn(js.board, js.current))
        tm = tbc.legal_mask_planes(ts.board, ts.current).numpy()
        np.testing.assert_array_equal(tm, jm, err_msg=f"mask at step {s}")
        actions = pick_actions(rng, jm.T, illegal_every=11, step=s)
        js = step(js, jnp.asarray(actions))
        ts = tbc.step_planes(ts, torch.from_numpy(actions))
        assert_same(js, ts, f"at step {s}")
        if s % 12 == 11:  # keep frozen games around for a while, then reset
            js, ts = jbc.autoreset_planes(js), tbc.autoreset_planes(ts)
            assert_same(js, ts, f"after reset at step {s}")
    assert np.asarray(js.done).any() or np.asarray(js.turn).max() > 0


def test_step_trusted_matches():
    B, S = 128, 40
    rng = np.random.default_rng(7)
    js, ts = jbc.reset_planes(B), tbc.reset_planes(B, CPU)
    step = jax.jit(jbc.step_trusted)
    for s in range(S):
        mask = tbc.legal_mask_planes(ts.board, ts.current).numpy().T
        actions = pick_actions(rng, mask)
        js = step(js, jnp.asarray(actions))
        ts = tbc.step_trusted(ts, torch.from_numpy(actions))
        assert_same(js, ts, f"at step {s}")
        # the trusted step equals the checked one on mask-derived actions
        if int(ts.done.sum()) > B // 2:
            js, ts = jbc.autoreset_planes(js), tbc.autoreset_planes(ts)


def test_apply_action_unchecked_and_winner_match():
    js, ts = random_states(seed=3)
    rng = np.random.default_rng(3)
    mask = np.asarray(jbc.legal_mask_planes(js.board, js.current)).T
    actions = pick_actions(rng, mask)
    jb = jbc.apply_action_unchecked(js.board, js.current, jnp.asarray(actions))
    tb = tbc.apply_action_unchecked(ts.board, ts.current, torch.from_numpy(actions))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tbc.flat_planes(tb).numpy(), np.asarray(jbc.flat_planes(jb)))
    np.testing.assert_array_equal(tbc.covered_planes(tb).numpy(),
                                  np.asarray(jbc.covered_planes(jb)))
    np.testing.assert_array_equal(tbc.winner_planes(tbc.flat_planes(tb)).numpy(),
                                  np.asarray(jbc.winner_planes(jbc.flat_planes(jb))))


def test_autoreset_matches():
    B = 64
    rng = np.random.default_rng(11)
    js = jbc.reset_planes(B)
    step, mask_fn = jax.jit(jbc.step_planes), jax.jit(jbc.legal_mask_planes)
    for _ in range(14):  # no reset: finished games stay done
        mask = np.asarray(mask_fn(js.board, js.current)).T
        js = step(js, jnp.asarray(pick_actions(rng, mask)))
    assert np.asarray(js.done).any()
    assert_same(jbc.autoreset_planes(js), tbc.autoreset_planes(to_torch(js)))


@pytest.mark.parametrize("seed", [0, 1])
def test_observation_planes_match(seed):
    js, ts = random_states(seed=seed)
    for agent_j, agent_t in ((js.current, ts.current), (1 - js.current, 1 - ts.current)):
        jp = jbc.observe_planes_lm(js.board, agent_j)
        tp = tbc.observe_planes_lm(ts.board, agent_t)
        assert tp.dtype == torch.int8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tbc.to_reference_obs(tp).numpy(),
                                      np.asarray(jbc.to_reference_obs(jp)))
        np.testing.assert_array_equal(tbc.features_lm(ts.board, agent_t).numpy(),
                                      np.asarray(jbc.features_lm(js.board, agent_j)))


def test_sample_random_lm_with_injected_gumbel():
    js, ts = random_states(B=200, seed=5)
    mask = tbc.legal_mask_planes(ts.board, ts.current)
    g = np.random.default_rng(5).gumbel(size=(54, 200)).astype(np.float32)
    g[:, :3] = 0.0  # all-tied rows: the lowest legal index wins in both
    got = tbc.sample_random_lm(None, mask, torch.from_numpy(g))
    want = jnp.argmax(jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(g), -jnp.inf), 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mask.numpy()[got.numpy(), np.arange(200)].all()


def test_sample_random_lm_needs_generator_or_field():
    mask = torch.ones((54, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        tbc.sample_random_lm(None, mask)
    g = torch.Generator().manual_seed(0)
    a = tbc.sample_random_lm(g, mask)
    assert a.dtype == torch.int32 and ((0 <= a) & (a < 54)).all()


def test_rollout_random_with_injected_field_matches_jax_loop():
    """The engine rollout, fed one Gumbel field, against the same ply loop
    written with the JAX module's functions."""
    B, S = 96, 24
    g = np.random.default_rng(9).gumbel(size=(S, 54, B)).astype(np.float32)
    ts, stats = tbc.rollout_random(tbc.reset_planes(B, CPU), None, S, torch.from_numpy(g))

    board, cur = jbc.reset_planes(B).board, jnp.zeros(B, jnp.int32)
    eps = w1 = w2 = 0
    for t in range(S):
        mask = jbc.legal_mask_planes(board, cur)
        a = jnp.argmax(jnp.where(mask, jnp.asarray(g[t]), -jnp.inf), 0).astype(jnp.int32)
        board = jbc.apply_action_unchecked(board, cur, a)
        win = jbc.winner_planes(jbc.flat_planes(board))
        done = win != 0
        eps += int(done.sum())
        w1 += int((win == 1).sum())
        w2 += int((win == -1).sum())
        board = jnp.where(done[None, None], jnp.int8(0), board)
        cur = jnp.where(done, 0, 1 - cur)
    np.testing.assert_array_equal(ts.board.numpy(), np.asarray(board))
    np.testing.assert_array_equal(ts.current.numpy(), np.asarray(cur))
    assert (int(stats["episodes"]), int(stats["wins_p1"]), int(stats["wins_p2"])) == (eps, w1, w2)
    assert eps == w1 + w2 and eps > 0
