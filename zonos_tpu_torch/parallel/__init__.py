"""Training and scale-out (zonos_tpu/parallel/): the teacher-forced loss with
CFG dropout, the step functions, AdamW / Adafactor with optax's arithmetic,
LoRA, and the ``("data", "model")`` mesh over ``torch.distributed``: the
mesh (``mesh.py``), the Megatron sharding rules (``sharding.py``), the
follower loop of a sharded server (``followers.py``) and the multi-process
dry run (``dryrun.py``).  The collectives the models call, and the readers
of a mesh's axes, are ``zonos_tpu_torch/ops/tp.py``."""

from zonos_tpu_torch.ops.tp import mesh_shape
from zonos_tpu_torch.parallel.dryrun import run_dryrun
from zonos_tpu_torch.parallel.followers import follow
from zonos_tpu_torch.parallel.lora import (
    DEFAULT_TARGETS,
    count_lora_params,
    init_lora,
    make_lora_eval_fn,
    make_lora_train_step,
    merge_lora,
)
from zonos_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from zonos_tpu_torch.parallel.sharding import (
    batch_sharding,
    kv_cache_sharding,
    param_shardings,
    replicated,
    shard_params,
    unshard_params,
    zonos_param_specs,
)
from zonos_tpu_torch.parallel.train import (
    Optimizer,
    apply_updates,
    conditioned_loss,
    make_conditioned_eval_fn,
    make_conditioned_train_step,
    make_optimizer,
    make_train_step,
    multicodebook_loss,
)

__all__ = [
    "DEFAULT_TARGETS",
    "Optimizer",
    "apply_updates",
    "batch_sharding",
    "conditioned_loss",
    "count_lora_params",
    "follow",
    "init_lora",
    "initialize_multihost",
    "kv_cache_sharding",
    "make_conditioned_eval_fn",
    "make_conditioned_train_step",
    "make_lora_eval_fn",
    "make_lora_train_step",
    "make_mesh",
    "make_optimizer",
    "make_train_step",
    "merge_lora",
    "mesh_shape",
    "multicodebook_loss",
    "param_shardings",
    "replicated",
    "run_dryrun",
    "shard_params",
    "unshard_params",
    "zonos_param_specs",
]
