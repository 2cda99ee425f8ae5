"""The analytic FLOP count of a DQN iteration equals what
``FlopCounterMode`` counts while today's code runs one, at a tiny size.

The counter sees every matmul (``addmm``, ``mm``) of the learner's forward
passes in collect and of the updates' forwards and backward.  It cannot
see the rules, the opponents or the ring (no matmul), which the analytic
count leaves out too; nor bias adds, ReLU, the dueling mean or the loss,
which neither counts."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flops import dqn_greedy


@pytest.mark.parametrize("opponent,seat", [("greedy", "both"), ("random", 0), ("self", "both"),
                                           ("random", 1)])
@pytest.mark.parametrize("double,dueling", [(True, True), (False, False)])
def test_dqn_iteration_flops(opponent, seat, double, dueling):
    from gobblet_rl_torch.train import dqn, replay

    cfg = dqn.DQNConfig(num_envs=8, buffer_size=512, batch_size=8, update_per_collect=2,
                        segment_len=4, opponent=opponent, learner_player=seat, double=double,
                        dueling=dueling, hidden_sizes=(16, 8))
    gen = torch.Generator()
    gen.manual_seed(3)
    ts = dqn.init_train_state(cfg, dqn.make_net(cfg, "cpu"), gen)
    it, opp = dqn.make_train_iteration(cfg)
    env = dqn.init_env_state(cfg, opp, ts.opponent_net, gen)
    buf = replay.make_buffer(cfg.buffer_size, "cpu")
    env, buf, _ = it(ts, env, buf, gen)        # the first iteration fills the ring
    with FlopCounterMode(display=False) as counter:
        it(ts, env, buf, gen)
    fields = {k: copy.copy(getattr(cfg, k)) for k in cfg.__dataclass_fields__}
    assert dqn_greedy.per_iteration(fields) == counter.get_total_flops()


def test_recipe_widths():
    fields = {"hidden_sizes": (128,) * 4, "dueling": True}
    assert dqn_greedy.forward_per_row(fields) == 142_336
