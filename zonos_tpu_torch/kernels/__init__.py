"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

A wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and runs the plain version only for CPU tensors.
``launch_counts`` counts kernel launches per wrapper; it grows only where a
kernel is launched, never on the CPU path.  A CUDA graph's replay runs no
wrapper: the graph's launches are taken at capture (:func:`launches_since`,
the capture's own count undone) and added once per replay
(:func:`add_launches`).

Gradients: a wrapper goes through a ``torch.autograd.Function`` exactly
when :func:`grad_required` says so (grad mode on, an input requiring grad),
so that a training forward reaching G1, N1 or K6 carries its gradient; any
other call launches as it always did.  No backward is a kernel of its own:
each is the plain version's own gradient (``kernels/gemm.py``,
``row_norm.py``, ``ssd.py``).
"""

import torch

launch_counts: dict[str, int] = {
    "flash_decode_attention": 0,
    "decode_attention_single": 0,
    "flash_decode_attention_f8": 0,
    "flash_decode_attention_int8": 0,
    "decode_attention_single_f8": 0,
    "decode_attention_single_int8": 0,
    "fused_sample": 0,
    "snake_conv1d": 0,
    "ssd_chunked": 0,
    "fused_state_step": 0,
    "fused_state_step_int8": 0,
    "fused_state_step_int4": 0,
    "fused_layer_tail": 0,
    "int4_matmul": 0,
    "gemm": 0,
    "gemm_norm": 0,
    "int4_matmul_norm": 0,
    "row_norm": 0,
}


def grad_required(*tensors) -> bool:
    """Whether a wrapper's launch must carry a gradient: grad mode is on and
    one of ``tensors`` (None allowed) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since ``before`` (a copy of ``launch_counts``)."""
    return {name: n - before[name] for name, n in launch_counts.items() if n != before[name]}


def add_launches(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        launch_counts[name] += n


# each kernel source under csrc/ and the module of its wrapper
_MODULES = {"decode_attention": "decode_attention", "sampling": "sampling",
            "snake_conv": "snake_conv", "ssd_chunked": "ssd", "ssm_state": "ssm_state",
            "layer_tail": "layer_tail", "int4_matmul": "int4_matmul", "gemm": "gemm",
            "row_norm": "row_norm"}


def load_all(device_index: int) -> int:
    """Build (where not built yet) and load every kernel library for the card
    ``device_index``, with each one's attributes set there, so that no later
    first launch does it; returns how many libraries."""
    import importlib

    from zonos_tpu_torch.kernels._build import build_all, library

    build_all(tuple(_MODULES))
    for source, module in _MODULES.items():
        mod = importlib.import_module(f"zonos_tpu_torch.kernels.{module}")
        if hasattr(mod, "_library"):  # the libraries that set attributes on the device
            mod._library(device_index)
        else:
            library(source, mod._SIGNATURES)
    return len(_MODULES)
