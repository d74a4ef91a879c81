"""Training on one device (zonos_tpu/parallel/): the teacher-forced loss with
CFG dropout, the step functions, AdamW / Adafactor with optax's arithmetic,
and LoRA.  The JAX package's meshes, sharding rules and multi-host dry runs
(``mesh.py``, ``sharding.py``, ``dryrun.py``) are not ported yet."""

from zonos_tpu_torch.parallel.lora import (
    DEFAULT_TARGETS,
    count_lora_params,
    init_lora,
    make_lora_eval_fn,
    make_lora_train_step,
    merge_lora,
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
    "conditioned_loss",
    "count_lora_params",
    "init_lora",
    "make_conditioned_eval_fn",
    "make_conditioned_train_step",
    "make_lora_eval_fn",
    "make_lora_train_step",
    "make_optimizer",
    "make_train_step",
    "merge_lora",
    "multicodebook_loss",
]
