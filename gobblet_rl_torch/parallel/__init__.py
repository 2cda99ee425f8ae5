"""Multi-device and multi-process scaling over ``torch.distributed``: the
(env x model) mesh, the data-parallel iterations of all three training
families, tensor parallelism with explicit collectives, the multi-process
runner and the collective audit.  Port of ``gobblet_rl_tpu/parallel/``."""

from gobblet_rl_torch.parallel.mesh import (
    ENV_AXIS,
    MODEL_AXIS,
    env_sharding,
    init_distributed,
    make_mesh,
    replicated,
    shard_env_state,
)

__all__ = [
    "ENV_AXIS",
    "MODEL_AXIS",
    "env_sharding",
    "init_distributed",
    "make_mesh",
    "replicated",
    "shard_env_state",
]
