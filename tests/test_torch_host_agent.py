"""``zoo.host_agent`` of the torch port against the JAX package's, on the CPU.

The agents wrap the zoo's evaluation policies at B=1 behind the reference
(3, 3, 13) observation; both are deterministic here (DQN and PPO take the
masked argmax, the AlphaZero agent the noise-free PUCT search at
temperature 0), so their actions can be compared, on every live position
of a few numpy-seeded random games.  The zoo nets compute in bfloat16, and
the two frameworks round differently, so the rule is:

* DQN and PPO: the port's Q-values (logits) lie within ``TOL`` = 2e-2 of
  the largest magnitude of JAX's; wherever JAX's two best legal values are
  more than ``2 * TOL`` apart, the actions are equal.
* AlphaZero (``num_sims`` = 8): wherever JAX's two best root scores (the
  visit counts, with proven wins and losses dominating) are at least
  ``VISIT_GAP`` = 2 visits apart, the actions are equal.

Each test asserts how many positions it compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo as tzoo
from gobblet_rl_torch.core import observe, rules_np
from gobblet_rl_tpu import zoo as jzoo
from gobblet_rl_tpu.ops import batched_core as jbc
from gobblet_rl_tpu.search import MCTSConfig as JMCTSConfig
from gobblet_rl_tpu.search import mcts_lm as jmcts_lm

TOL = 2e-2
VISIT_GAP = 2
AZ_SIMS = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_positions(seed, games, max_plies=30):
    """(observation, mask, board int8[3, 9], player) at every live position
    of ``games`` numpy-seeded random games."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(games):
        board, player = rules_np.empty_board(), 0
        for _ in range(max_plies):
            obs, mask = observe.observe_np(board, player, player)
            out.append((obs, mask, board, player))
            board = rules_np.apply_action(board, player, int(rng.choice(np.nonzero(mask)[0])))
            if rules_np.line_winner(board):
                break
            player = 1 - player
    return out


def jax_values(name, positions):
    """JAX's Q-values (dqn) or actor logits (ppo) on the positions,
    float32[n, 54], and the masks."""
    net, params, entry = jzoo.load(name)
    boards = np.stack([b for _, _, b, _ in positions], -1)                 # [3, 9, n]
    players = np.array([p for _, _, _, p in positions], np.int32)
    feats = jbc.features_lm(jnp.asarray(boards), jnp.asarray(players)).T
    out = net.apply(params, feats)
    values = out[0] if entry["family"] == "ppo" else out
    return np.asarray(values, np.float32), np.stack([m for _, m, _, _ in positions]).astype(bool)


def torch_values(name, positions):
    from gobblet_rl_torch.ops import batched_core as tbc

    net, _, entry = tzoo.load(name, device="cpu")
    boards = torch.from_numpy(np.stack([b for _, _, b, _ in positions], -1))
    players = torch.tensor([p for _, _, _, p in positions], dtype=torch.int32)
    with torch.no_grad():
        out = net(tbc.features_lm(boards, players).t())
    return (out[0] if entry["family"] == "ppo" else out).float().numpy()


@pytest.mark.parametrize("name", ["dqn_greedy", "ppo_league"])
def test_value_agents_equal_jax(name):
    positions = seeded_positions(41, games=6)
    jv, masks = jax_values(name, positions)
    tv = torch_values(name, positions)
    legal_j = np.where(masks, jv, -np.inf)
    scale = np.abs(np.where(masks, jv, 0)).max(1)
    err = np.abs(np.where(masks, tv - jv, 0)).max(1)
    assert (err <= TOL * scale).all(), float((err / scale).max())

    top2 = np.sort(legal_j, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL * scale
    tagent = tzoo.host_agent(name, seed=0, device="cpu")
    jagent = jzoo.host_agent(name, seed=0)
    compared = 0
    for i, (obs, mask, _, _) in enumerate(positions):
        ta, ja = tagent.compute_action(obs, mask), jagent.compute_action(obs, mask)
        assert mask[ta] == 1
        if clear[i]:
            assert ta == ja, (name, i, ta, ja)
            compared += 1
    assert len(positions) >= 40 and compared >= len(positions) // 2, (compared, len(positions))


def test_alphazero_agent_equals_jax():
    positions = seeded_positions(43, games=2, max_plies=14)
    net, params, _ = jzoo.load("alphazero_gumbel32")
    search = jax.jit(lambda b, c: jmcts_lm.mcts_search_lm(
        lambda p, o: net.apply(p, o), params, b, c, jax.random.PRNGKey(0),
        JMCTSConfig(num_sims=AZ_SIMS)))
    tagent = tzoo.host_agent("alphazero_gumbel32", seed=0, device="cpu", num_sims=AZ_SIMS)
    jagent = jzoo.host_agent("alphazero_gumbel32", seed=0, num_sims=AZ_SIMS)
    compared = 0
    for i, (obs, mask, board, player) in enumerate(positions):
        ta, ja = tagent.compute_action(obs, mask), jagent.compute_action(obs, mask)
        assert mask[ta] == 1
        visits, q, root_win = (np.asarray(x)[0] for x in search(
            jnp.asarray(board)[..., None], jnp.asarray([player], jnp.int32)))
        score = visits + 1e9 * root_win + 1e6 * (q >= 0.999) - 1e6 * (np.isfinite(q) & (q <= -0.999))
        top2 = np.sort(np.where(mask.astype(bool), score, -np.inf))[-2:]
        if top2[1] - top2[0] >= VISIT_GAP:
            assert ta == ja, (i, ta, ja)
            compared += 1
    assert len(positions) >= 20 and compared >= len(positions) // 2, (compared, len(positions))


def test_host_agent_device_none_means_cuda():
    if torch.cuda.is_available():
        obs, mask, _, _ = seeded_positions(47, games=1)[3]
        assert mask[tzoo.host_agent("dqn_greedy").compute_action(obs, mask)] == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tzoo.host_agent("dqn_greedy")
