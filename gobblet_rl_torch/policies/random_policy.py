"""Random-admissible policies: on the host (numpy) and batched (torch).

Port of ``gobblet_rl_tpu/policies/random_policy.py``.  The host policies
draw as the reference's examples do (``np.random.choice`` over the legal
indices of the action mask), so under one seed they draw what the JAX
package's draw.  :func:`batched_random_admissible` is a masked categorical
draw, a Gumbel argmax as JAX's ``jax.random.categorical`` is, on the
masks' device.
"""

from __future__ import annotations

import numpy as np
import torch

from gobblet_rl_torch.ops import batched_core as bc


def random_admissible_action(mask: np.ndarray, rng: np.random.Generator | None = None) -> int:
    """Uniform draw from the legal actions; ``rng`` ``None`` draws from the
    global ``np.random``."""
    legal = np.nonzero(np.asarray(mask).flatten())[0]
    if rng is None:
        return int(np.random.choice(legal))
    return int(rng.choice(legal))


def batched_random_admissible(generator: torch.Generator | None, masks: torch.Tensor,
                              gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B] uniform-over-mask actions for ``masks`` [B, 54]: the argmax
    of Gumbel noise over the legal actions (ties to the lowest index).
    ``gumbel`` is an optional pre-drawn float32 [B, 54] field; without it
    the noise comes from ``generator`` on the masks' device."""
    if gumbel is None:
        if generator is None:
            raise ValueError("batched_random_admissible needs a generator or a gumbel field")
        gumbel = bc.gumbel_field(generator, masks.shape, masks.device)
    return torch.where(masks.to(torch.bool), gumbel, -torch.inf).argmax(dim=-1).to(torch.int32)


class RandomAdmissiblePolicy:
    """Object wrapper with the RLlib adapter's surface: one action, or a
    list of actions for a batch of observations."""

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)

    def compute_action(self, obs, mask) -> int:
        return random_admissible_action(mask, self.rng)

    def compute_actions(self, obs_batch):
        masks = obs_batch["action_mask"]
        return [random_admissible_action(m, self.rng) for m in masks]
