"""Training checkpoints: save and resume (zonos_tpu/utils/train_state.py).

``save_train_state`` writes ``(params, opt_state, step)`` with ``torch.save``
into ``<ckpt_dir>/<step>/state.pt`` (written to a temporary name, then
renamed, so a killed job never leaves a partial checkpoint) and keeps the
``max_to_keep`` newest; ``restore_train_state`` reads the newest back onto
the devices of a template's tensors.  The JAX package checkpoints with
orbax, which the port does not use.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

STATE_FILE = "state.pt"


def _steps(ckpt_dir: Path) -> list[int]:
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).exists())


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _placed(tree, template):
    """``tree``'s tensors on the devices of ``template``'s (the structures
    match; a template without tensors there keeps the host tensor)."""
    if isinstance(tree, dict):
        return {k: _placed(v, template.get(k) if isinstance(template, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, template[i] if isinstance(template, (list, tuple))
                        and i < len(template) else None) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor) and isinstance(template, torch.Tensor):
        return tree.to(template.device)
    return tree


def save_train_state(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                     max_to_keep: int = 3) -> None:
    """Write the checkpoint of ``step`` and delete all but the
    ``max_to_keep`` newest."""
    root = Path(ckpt_dir)
    target = root / str(step)
    target.mkdir(parents=True, exist_ok=True)
    tmp = target / (STATE_FILE + ".tmp")
    torch.save({"step": step, "params": _to_host(params), "opt_state": _to_host(opt_state)},
               tmp)
    os.replace(tmp, target / STATE_FILE)
    for old in _steps(root)[:-max_to_keep]:
        shutil.rmtree(root / str(old), ignore_errors=True)


def restore_train_state(ckpt_dir: str, params_template: Any, opt_state_template: Any):
    """``(step, params, opt_state)`` of the newest checkpoint, each tensor on
    the device of the template's tensor at its place, or None if there is
    none."""
    steps = _steps(Path(ckpt_dir))
    if not steps:
        return None
    state = torch.load(Path(ckpt_dir) / str(steps[-1]) / STATE_FILE, map_location="cpu",
                       weights_only=True)
    return (state["step"], _placed(state["params"], params_template),
            _placed(state["opt_state"], opt_state_template))


def save_inference_params(path: str, params: Any) -> None:
    """The parameters alone, as one ``torch.save`` file (the reference
    format, ``config.json`` + ``model.safetensors``, is
    ``utils/checkpoint.py`` ``export_zonos_checkpoint``)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_host(params), path)


def load_inference_params(path: str, template: Any) -> Any:
    """The parameters :func:`save_inference_params` wrote, on the devices of
    ``template``'s tensors."""
    return _placed(torch.load(path, map_location="cpu", weights_only=True), template)


def profile_trace(log_dir: str):
    """A context manager that writes a ``torch.profiler`` Chrome trace of its
    block into ``log_dir/trace.json`` (``utils/profiling.py`` ``device_trace``)."""
    from zonos_tpu_torch.utils.profiling import device_trace

    return device_trace(log_dir)
