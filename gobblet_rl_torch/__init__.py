"""gobblet_rl_torch — the Gobblet RL framework on PyTorch and CUDA (Hopper).

A port of :mod:`gobblet_rl_tpu` that keeps its module names, so each module
here has its JAX counterpart at the same path.  The package imports
``torch`` and ``numpy`` only; it never imports JAX or the JAX package.

Entry points run on the CUDA card unless the caller passes a device
(``device="cpu"`` runs the plain tensor code, as the tests do).

Layout:

* ``core/types.py``        sizes, per-action tables (numpy), ``GobbletState``
* ``core/rules.py``, ``core/observe.py``, ``core/env.py``  the per-env
  functional API over a leading batch (``reset``, ``step_raw``,
  ``step_strict``); ``core/rules_np.py`` its NumPy twin for host code
* ``device.py``            ``device=None`` -> CUDA, or raise
* ``ops/batched_core.py``  the lane-major ``[3, 9, B]`` engine;
  ``ops/debug.py`` its invariant checks
* ``kernels/rollout.py``   the fused random rollout (hand-written CUDA,
  ``kernels/csrc/rollout.cu``) and its plain version
* ``kernels/draw.py``, ``kernels/wins.py``  the uniform legal draw and the
  one-move win check (hand-written CUDA, ``kernels/csrc/draw.cu`` and
  ``wins.cu``), each with its plain version
* ``models/mlp.py``        ``QNet`` + masked argmax
* ``models/actor_critic.py``  ``ConvActorCritic`` / ``MLPActorCritic`` and the
  masked sampling helpers; ``models/convert.py`` carries parameters
  between flax trees and the modules
* ``search/``              Gumbel (sequential halving) and PUCT searches on
  lane-major trees, with batch-first entry points
* ``policies/greedy_jax.py``  the batched depth-1/2 greedy opponent;
  ``policies/value_search.py`` the learned-eval depth-1/2 search (the
  ``+search2`` entrants); ``policies/greedy.py``, ``random_policy.py``
  and ``alphabeta.py`` the host greedy, random and alpha-beta policies
* ``env/vector.py``        the batch-first vector env and its rollout
* ``native/engine.py``     ``NativeEngine`` (the single-env C++ rules,
  greedy, playouts and matches), the exact solver and the alpha-beta
  expert of ``csrc/gobblet.cpp``, built by ``g++`` at first use
* ``train/replay.py``      the state-snapshot replay ring and the n-step
  ``Segment`` folds
* ``train/dqn.py``         the fused DQN actor-learner (random, greedy, self
  and mixed opponents, the defense term; checkpoints and exact resume)
* ``train/alphazero.py``   AlphaZero self-play (Gumbel or PUCT), outcome
  backfill, clipped AdamW updates; checkpoints and exact resume
* ``train/ppo.py``         PPO self-play with its opponents and league;
  ``train/defense.py`` the solver-supervised defense bank
* ``train/checkpoint.py``  ``torch.save`` checkpoints, full resume points
* ``train/logging.py``     JSONL (and TensorBoard) metrics
* ``eval/tournament.py``   the random, greedy, DQN, PPO, alpha-beta and
  solver policies, ``play_match``, ``defense_audit``, ``round_robin``
* ``zoo/``                 the committed ``dqn``, ``alphazero`` and ``ppo``
  agents, read from the JAX package's blobs by a msgpack reader of its own,
  ``save`` (flax blobs by its own writer, into ``$GOBBLET_ZOO_DIR``), and
  ``host_agent``, one of them at B=1 behind the reference observation
* ``utils/``               ``profiling`` (``trace``; ``annotate``, the
  program's span, off unless ``torch.profiler`` records; ``count``, its
  counters; ``span_table``, spans and counters by name with host and
  stream ms; ``Throughput``) and ``helpers``
* ``examples/``            the DQN, AlphaZero (with ``SearchAgentPolicy`` and
  the ``--watch`` modes; DQN's play mode), PPO and tournament command lines,
  and the host demos ``example_basic``, ``example_greedy``,
  ``example_record_game`` and ``example_user_input``, and the desktop
  demo loops ``main`` and ``main_random``
* ``scripts/``             ``make_zoo`` (the zoo's recipes), ``exploitability``
  (the exact-solver audit) and ``profile_dqn`` (device time by kernel)
* ``tutorials/``           the greedy and tiny-AlphaZero tutorials
* ``board.py``, ``render/``, ``env/aec.py``, ``gobblet_v1.py``,
  ``interactive/``, ``adapters/``  the host surface: the PettingZoo AEC env,
  its renders and GIF recorder, ``GameSession``, the pygame manual policy
  and the Tianshou and RLlib adapters.  The env, the manual policy, the
  host demos and the watch and play modes need ``pettingzoo``,
  ``gymnasium`` and, to draw, ``pygame``; the adapters need their
  framework.

* ``parallel/``            parallelism over ``torch.distributed`` (NCCL on
  the card, gloo on the CPU), one process a rank: the (env x model) mesh
  and the gradient sync, the data-parallel DQN, AlphaZero and PPO
  iterations, tensor parallelism with explicit collectives, the
  multi-process runner and the collective audit

Every module of the JAX package has its counterpart here.
"""

from gobblet_rl_torch.__version__ import __version__
