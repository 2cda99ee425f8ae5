"""gobblet_rl_torch — the Gobblet RL framework on PyTorch and CUDA (Hopper).

A port of :mod:`gobblet_rl_tpu` that keeps its module names, so each module
here has its JAX counterpart at the same path.  The package imports
``torch`` and ``numpy`` only; it never imports JAX or the JAX package.

Entry points run on the CUDA card unless the caller passes a device
(``device="cpu"`` runs the plain tensor code, as the tests do).

Layout:

* ``core/types.py``        sizes and per-action tables (numpy)
* ``device.py``            ``device=None`` -> CUDA, or raise
* ``ops/batched_core.py``  the lane-major ``[3, 9, B]`` engine
* ``kernels/rollout.py``   the fused random rollout (hand-written CUDA,
  ``kernels/csrc/rollout.cu``) and its plain version
* ``models/mlp.py``        ``QNet`` + masked argmax
* ``models/actor_critic.py``  ``ConvActorCritic`` / ``MLPActorCritic`` and the
  masked sampling helpers; ``models/convert.py`` loads flax parameters
* ``search/``              Gumbel (sequential halving) and PUCT searches on
  lane-major trees, with batch-first entry points
* ``policies/greedy_jax.py``  the batched depth-1/2 greedy opponent
* ``env/vector.py``        the batch-first vector env and its rollout
* ``train/replay.py``      the state-snapshot replay ring and the n-step
  ``Segment`` folds
* ``train/dqn.py``         the fused DQN actor-learner (random, greedy, self
  and mixed opponents; checkpoints and exact resume)
* ``train/alphazero.py``   AlphaZero self-play (Gumbel or PUCT), outcome
  backfill, clipped AdamW updates; checkpoints and exact resume
* ``train/checkpoint.py``  ``torch.save`` checkpoints, full resume points
* ``train/logging.py``     JSONL (and TensorBoard) metrics
* ``eval/tournament.py``   random, greedy and DQN policies, ``play_match``
* ``zoo/``                 the committed ``dqn`` and ``alphazero`` agents, read
  from the JAX package's blobs by a msgpack reader of its own
* ``examples/example_dqn.py``, ``examples/example_alphazero.py``  the DQN and
  AlphaZero command lines (training mode)

Not ported yet: PPO (its trainer, policy and zoo family), the defense
bank, the rest of evaluation, parallelism and the host surface
(``ROADMAP.md`` §A).
"""

__version__ = "0.1.0"
