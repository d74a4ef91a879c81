"""Carry weights across from the JAX package.

Both functions take the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and return the port's parameters as
tensors on ``device``.  float32 arrays and ``ml_dtypes`` bfloat16 arrays are
accepted; bfloat16 bytes are reinterpreted through ``uint16`` because
``torch.from_numpy`` rejects that dtype.

Layouts:
- Zonos: the port keeps the JAX layout, so the tree maps one to one:
  layers stacked on axis 0, matmul weights ``[in, out]`` applied as
  ``x @ w``, ``w1`` with the up half before the gate half, embeddings
  ``[9, 1152, d]`` with zero pad rows, heads ``[d, 9*1152]``.
- DAC (decode side): conv ``[K, C_in, C_out]`` -> torch ``[C_out, C_in, K]``;
  transposed conv ``[K, C_in, C_out]`` -> torch ``[C_in, C_out, K]`` (torch's
  transposed conv has the kernel flip the JAX version applies at call time).
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(x, fn, path=()):
    if isinstance(x, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn, path + (i,)) for i, v in enumerate(x)]
    return fn(x, path)


def convert_zonos_params(params: dict, device="cpu", dtype: torch.dtype | None = None) -> dict:
    """JAX ``Zonos.params`` (numpy leaves) -> the port's ``Zonos`` params.
    ``dtype`` recasts the floating leaves, except the Fourier conditioners'
    random features, which stay fp32 as in the JAX init."""

    def leaf(a, path):
        t = to_tensor(a, device)
        fourier = path[0] == "prefix_conditioner" and path[-1] == "weight"
        return t.to(dtype) if dtype is not None and t.is_floating_point() and not fourier else t

    return _tree(params, leaf)


def _conv(p: dict, device, transposed: bool = False) -> dict:
    w = np.asarray(p["w"], np.float32)
    w = np.transpose(w, (1, 2, 0) if transposed else (2, 1, 0))
    return {"w": to_tensor(w, device), "b": to_tensor(np.asarray(p["b"], np.float32), device)}


def _res_unit(p: dict, device) -> dict:
    return {
        "alpha1": to_tensor(np.asarray(p["alpha1"], np.float32), device),
        "conv1": _conv(p["conv1"], device),
        "alpha2": to_tensor(np.asarray(p["alpha2"], np.float32), device),
        "conv2": _conv(p["conv2"], device),
    }


def convert_dac_params(params: dict, device="cpu") -> dict:
    """JAX DAC params (numpy leaves) -> the port's decode-side DAC params."""
    dec = params["decoder"]
    f32 = lambda a: to_tensor(np.asarray(a, np.float32), device)  # noqa: E731
    return {
        "decoder": {
            "conv1": _conv(dec["conv1"], device),
            "blocks": [
                {
                    "alpha": f32(b["alpha"]),
                    "up": _conv(b["up"], device, transposed=True),
                    "res1": _res_unit(b["res1"], device),
                    "res2": _res_unit(b["res2"], device),
                    "res3": _res_unit(b["res3"], device),
                }
                for b in dec["blocks"]
            ],
            "alpha": f32(dec["alpha"]),
            "conv2": _conv(dec["conv2"], device),
        },
        "quantizers": [
            {"out_proj": _conv(q["out_proj"], device), "codebook": f32(q["codebook"])}
            for q in params["quantizers"]
        ],
    }
