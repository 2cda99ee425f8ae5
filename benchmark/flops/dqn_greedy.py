"""The matmul FLOPs a DQN iteration of the ``dqn_greedy`` configuration
needs, counted from its widths, whatever implements them.

A forward pass of the Q-net costs ``2 * (in * out)`` FLOPs a row for each
layer (the hidden layers, the advantage head and, when dueling, the value
row).  An iteration:

* collect: one learner forward a learner turn, over every env, for
  ``segment_len + n_step - 1`` turns (the greedy and random opponents do
  no matmul; a "self" opponent adds its forward for each reply);
* updates: ``update_per_collect`` minibatches of ``batch_size`` rows, each
  with the target net's forward on the next observations, the online
  net's forward on them (double DQN), and the online forward and backward
  on the observations.  The backward costs twice the forward, less the
  input layer's gradient with respect to its input, which nothing needs.

Bias adds, the dueling mean, ReLU and the loss are not counted.
"""

from __future__ import annotations

INPUTS, ACTIONS = 117, 54


def forward_per_row(fields: dict) -> int:
    widths = [INPUTS, *fields["hidden_sizes"]]
    macs = sum(a * b for a, b in zip(widths, widths[1:])) + widths[-1] * ACTIONS
    if fields["dueling"]:
        macs += widths[-1]
    return 2 * macs


def per_iteration(fields: dict) -> int:
    fwd = forward_per_row(fields)
    turns = fields["segment_len"] + fields["n_step"] - 1
    collect = turns * fields["num_envs"] * fwd
    if fields["opponent"] == "self":
        replies = 2 if fields["learner_player"] != 0 else 1
        collect += replies * turns * fields["num_envs"] * fwd
    backward = 2 * fwd - 2 * INPUTS * fields["hidden_sizes"][0]
    forwards = 3 if fields["double"] else 2
    update = (forwards * fwd + backward) * fields["batch_size"]
    return collect + fields["update_per_collect"] * update
