"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

A wrapper launches its kernel for CUDA tensors (or raises on what the
kernel does not take) and runs the plain version only for CPU tensors.
``launch_counts`` counts kernel launches per wrapper; it grows only where a
kernel is launched, never on the CPU path.
"""

launch_counts: dict[str, int] = {
    "flash_decode_attention": 0,
    "decode_attention_single": 0,
    "fused_sample": 0,
    "snake_conv1d": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
