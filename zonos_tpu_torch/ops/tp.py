"""Tensor parallelism as the models see it: the ``("data", "model")`` mesh's
axes, the model axis a block runs under, and the collectives called by hand
where GSPMD inserts them in the JAX package (zonos_tpu/parallel/sharding.py:
1-15), each with the gradient Megatron gives it:

- :func:`copy_to_model`: the identity; its backward all-reduces over
  ``"model"`` (a replicated activation read by a column-parallel product);
- :func:`reduce_from_model`: an all-reduce over ``"model"`` (the partial sums
  of a row-parallel product); its backward is the identity;
- :func:`gather_from_model`: an all-gather along the last axis (the heads'
  vocab-parallel logits, an int4 row-parallel input); its backward keeps
  this rank's slice.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the gradient again, which scales every replicated gradient by
the model size.  Over a group of one process each is the identity and
launches nothing.

The group comes from :func:`model_axis`, which ``Zonos`` and the training
steps enter around their work; the backbones then need no group argument,
and size their KV caches from :func:`model_size`.  It is one process-wide
value (not per thread): the autograd engine runs a backward, and a remat's
recompute, on threads of its own.  Meshes are made by
``zonos_tpu_torch/parallel/mesh.py``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from zonos_tpu_torch.kernels.row_norm import Norm
from zonos_tpu_torch.ops.norms import apply_norm
from zonos_tpu_torch.ops.quant import matmul_w, norm_matmul

AXES = ("data", "model")

_MODEL_GROUP: list = [None]


# ---------------------------------------------------------------------------
# The mesh's axes
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> dict[str, int]:
    """``{"data": n_data, "model": n_model}`` (1x1 without a mesh)."""
    return {axis: axis_size(mesh, axis) for axis in AXES}


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank along ``axis``, or None where the axis
    has one rank (every collective over it is then skipped)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def world_of(mesh):
    """The mesh's whole world as a group, or None for a mesh of one process."""
    return None if mesh is None or mesh.size() == 1 else dist.group.WORLD


def gather_objects(obj, group) -> list:
    """Every rank's ``obj`` in rank order (``[obj]`` without a group)."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# The model axis and its collectives
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def model_axis(group):
    """Run the block with ``group`` as the model axis (None: no tensor
    parallelism); the previous one comes back after it."""
    prev = _MODEL_GROUP[0]
    _MODEL_GROUP[0] = group
    try:
        yield
    finally:
        _MODEL_GROUP[0] = prev


def model_size() -> int:
    group = _MODEL_GROUP[0]
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x [..., w]`` side by side in rank order -> ``[..., n*w]``:
    the sum of copies that are zero outside each rank's columns (exact:
    every column has one term).  gloo, which gathers no CUDA tensor, sums
    them; so does NCCL."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w = x.shape[-1]
    out = torch.zeros((*x.shape[:-1], n * w), dtype=x.dtype, device=x.device)
    out[..., r * w:(r + 1) * w] = x
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.w, ctx.r = x.shape[-1], dist.get_rank(group)
        return all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.r * ctx.w:(ctx.r + 1) * ctx.w].contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    group = _MODEL_GROUP[0]
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    group = _MODEL_GROUP[0]
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    group = _MODEL_GROUP[0]
    return x if group is None else _GatherFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# The two Megatron products
# ---------------------------------------------------------------------------


def column_parallel(x: torch.Tensor, norm: Norm, w, dtype: torch.dtype | None = None
                    ) -> torch.Tensor:
    """A layer's norm and the column-parallel product that reads it
    (``wqkv``, ``w1``): :func:`~zonos_tpu_torch.ops.quant.norm_matmul`, whose
    fold into G1/K8 stays, since copy-to-model is the identity forward.
    Under autograd on a model axis the norm runs first and copy-to-model sits
    between it and the product, so the replicated norm's parameters get the
    whole gradient, not one rank's part."""
    if _MODEL_GROUP[0] is None or not torch.is_grad_enabled():
        return norm_matmul(x, norm, w, dtype)
    h = apply_norm(x, norm).to(dtype or x.dtype)
    return matmul_w(copy_to_model(h), w)


def row_parallel(x: torch.Tensor, w) -> torch.Tensor:
    """A row-parallel product (``wo``, ``w2``) of this rank's activation
    columns, summed over the model axis.  An int4 weight is replicated (its
    packed layout cannot be cut by rows): the activation is gathered first
    and the whole product runs on every rank, with no sum after it, as GSPMD
    runs it."""
    if _MODEL_GROUP[0] is None:
        return matmul_w(x, w)
    if isinstance(w, dict) and "q4" in w:
        return matmul_w(gather_from_model(x), w)
    return reduce_from_model(matmul_w(x, w))


def local_heads(n_heads: int, n_heads_kv: int, head_dim: int, wqkv) -> tuple[int, int]:
    """This rank's query and kv head counts, from the width of its ``wqkv``
    shard (``[q | k | v]``, each cut into the model size's parts)."""
    width = (wqkv["q4"] if "q4" in wqkv else wqkv["q"]).shape[-1] if isinstance(wqkv, dict) \
        else wqkv.shape[-1]
    tp = (n_heads + 2 * n_heads_kv) * head_dim // width
    return n_heads // tp, n_heads_kv // tp
