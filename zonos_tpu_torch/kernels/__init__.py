"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

A wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and runs the plain version only for CPU tensors.
``launch_counts`` counts kernel launches per wrapper; it grows only where a
kernel is launched, never on the CPU path.  A CUDA graph's replay runs no
wrapper: the graph's launches are taken at capture (:func:`launches_since`,
the capture's own count undone) and added once per replay
(:func:`add_launches`).
"""

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
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since ``before`` (a copy of ``launch_counts``)."""
    return {name: n - before[name] for name, n in launch_counts.items() if n != before[name]}


def add_launches(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        launch_counts[name] += n
