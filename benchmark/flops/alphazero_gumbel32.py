"""The FLOPs an AlphaZero iteration of the ``alphazero_gumbel32``
configuration needs, counted from its widths, whatever implements them.

A forward pass of the net costs, a row, ``2 * 9 * 9 * in * out`` for each
3x3 convolution over the 3x3 board ("SAME" padding: 9 output cells, 9
taps each, the padded taps counted as a dense convolution counts them),
and ``2 * 9 * channels * out`` for each head (54 logits and one value).
At 64 channels and 2 blocks that is 2 * (9*9*13*64 + 4*9*9*64*64 +
576*55) = 2,852,352 a row.  An iteration:

* the search: ``segment_len`` plies, each ``num_sims + 1`` evaluations
  (the root's and one a simulation) of every one of ``num_envs`` roots;
* the updates: ``updates_per_iter`` minibatches of ``mb = min(batch_size,
  rows // updates_per_iter)`` rows, ``rows = num_envs * segment_len``,
  each a forward and a backward.  The backward costs twice the forward,
  less the stem convolution's gradient with respect to its input, which
  nothing needs.

Bias adds, ReLU, the residual adds, the softmax and the loss, the rules
and the tree's arithmetic are not counted.
"""

from __future__ import annotations

OBS_CHANNELS, ACTIONS, CELLS, TAPS = 13, 54, 9, 9


def stem_per_row(fields: dict) -> int:
    return 2 * CELLS * TAPS * OBS_CHANNELS * fields["channels"]


def forward_per_row(fields: dict) -> int:
    c = fields["channels"]
    convs = stem_per_row(fields) + 2 * fields["blocks"] * 2 * CELLS * TAPS * c * c
    return convs + 2 * CELLS * c * (ACTIONS + 1)


def per_iteration(fields: dict) -> int:
    fwd = forward_per_row(fields)
    B, L, U = fields["num_envs"], fields["segment_len"], fields["updates_per_iter"]
    search = L * (fields["num_sims"] + 1) * B * fwd
    mb = max(1, min(fields["batch_size"], B * L // max(U, 1)))
    return search + U * mb * (3 * fwd - stem_per_row(fields))
