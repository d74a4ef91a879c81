"""Training: the teacher-forced multi-codebook loss with classifier-free-
guidance dropout, the step functions and the optimizers
(zonos_tpu/parallel/train.py).

- :func:`multicodebook_loss`: the delay pattern applied to the codes, every
  position teacher-forced, the 9 codebooks' cross-entropy with mask-token
  targets excluded; both backbones (``transformer_forward`` with optional
  remat, the hybrid's state-free ``hybrid_forward``).
- :func:`conditioned_loss`: the prefix conditioner inside the differentiated
  region, with CFG dropout: a joint mask, then each conditioner's own, drawn
  in that order from an explicit ``torch.Generator`` (or given as
  ``uncond_drop``).
- :func:`make_train_step` / :func:`make_conditioned_train_step`:
  ``(params, opt_state, ...) -> (params, opt_state, loss)``, the JAX form;
  ``accum_steps`` micro-batches accumulate fp32 gradients, cast to the
  parameters' dtype.  :func:`make_conditioned_eval_fn` runs under ``no_grad``.
- :func:`make_optimizer`: optax's ``clip_by_global_norm`` and ``adamw`` or
  ``adafactor`` (the settings of zonos_tpu/parallel/train.py:224-230; not
  ``torch.optim.Adafactor``, a different algorithm), with optax's warmup-
  cosine or linear schedule, computed as optax computes them.  Moments are
  kept in the parameters' dtype, as optax keeps them.

On a ``("data", "model")`` mesh (``mesh=``; one process a device) every
rank calls a step with the same whole batch.  Each data rank takes its rows
of each micro-batch (and of its CFG dropout masks, drawn for the whole
micro-batch from the same generator on every rank); the loss is
``sum(nll * valid) / sum(valid)`` over the whole micro-batch, each rank
summing its own rows over the whole batch's valid count (the mean of the
shards' means is not the global mean when rows hold different numbers of
valid targets); gradients and the loss are summed over ``"data"``.  Over
``"model"`` the backbones and the heads run their shards
(``ops/tp.py``); the optimizer sums a sharded leaf's squares
over the axis for the global norm, and Adafactor picks its factored axes
from the whole leaf's shape and averages over a sharded axis across it.

Parameters are the port's dicts (and lists) of tensors.  Every floating leaf
trains, as every leaf of the JAX tree does; a leaf the loss does not reach
gets a zero gradient, as ``jax.grad`` gives it.  On the card the training
forward reaches G1, N1 and K6 through their autograd routes
(``kernels/__init__.py`` ``grad_required``); the embeddings' gather, the
attention and the conditioner's products are plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from zonos_tpu_torch.conditioning import prefix_conditioner_forward
from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import transformer_forward
from zonos_tpu_torch.models.hybrid import hybrid_forward
from zonos_tpu_torch.models.tts import embed_codes, head_logits
from zonos_tpu_torch.ops.delay import apply_delay_pattern
from zonos_tpu_torch.ops.tp import axis_group, axis_size, model_axis

# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> tuple[list, Callable[[list], object]]:
    """The leaves of a tree of dicts and lists (None leaves kept as slots),
    in dict order, and the function that rebuilds the tree from new leaves."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        leaves.append(t)
        return len(leaves) - 1

    skeleton = walk(tree)

    def rebuild(new: list):
        def fill(s):
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            if isinstance(s, list):
                return [fill(v) for v in s]
            return new[s]

        return fill(skeleton)

    return leaves, rebuild


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, None slots left out."""
    return [t for t in tree_flatten(tree)[0] if t is not None]


def value_and_grad(loss_fn: Callable, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``: grads mirrors
    ``params``, None where a leaf is not floating or the loss does not reach
    it.  The leaves are differentiated through detached aliases, so the
    caller's tensors keep ``requires_grad`` False."""
    leaves, rebuild = tree_flatten(params)
    live = [t.detach().requires_grad_(True) if t is not None and t.is_floating_point() else t
            for t in leaves]
    loss = loss_fn(rebuild(live), *args)
    wanted = [t for t in live if t is not None and t.requires_grad]
    grads = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    return loss.detach(), rebuild([next(grads) if t is not None and t.requires_grad else None
                                   for t in live])


def _filled(grads, params) -> list:
    """The gradient leaves with a zero one for every floating leaf the loss
    did not reach (``jax.grad`` gives zeros there); None for the others."""
    return [torch.zeros_like(p) if g is None and p is not None and p.is_floating_point() else g
            for g, p in zip(tree_flatten(grads)[0], tree_flatten(params)[0])]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _backbone_forward(cfg: ZonosConfig, params: dict, x: torch.Tensor, remat: bool):
    if cfg.backbone.is_transformer:
        return transformer_forward(cfg.backbone, params["backbone"], x, remat=remat)
    return hybrid_forward(cfg.backbone, params["backbone"], x)  # JAX ignores remat here too


def teacher_forced_logits(cfg: ZonosConfig, params: dict, cond: torch.Tensor, codes,
                          remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """cond [B, Lc, d], codes [B, K, T] raw (no delay) -> (fp32 logits
    [B, T+K-1, K, V_pad], targets [B, T+K-1, K]).  The hidden state at the
    position of ``delayed[j]`` predicts ``delayed[j+1]``, the decode loop's
    contract (the step's hidden state yields the next delayed frame)."""
    K, Vp = cfg.num_codebooks, cfg.padded_vocab_size
    codes = torch.as_tensor(codes, device=cond.device).long()
    delayed = apply_delay_pattern(codes, cfg.masked_token_id)  # [B, K, T+K]
    T = delayed.shape[-1]
    inputs, targets = delayed[..., : T - 1], delayed[..., 1:]
    x = torch.cat([cond, embed_codes(params, inputs).to(cond.dtype)], dim=1)
    hidden = _backbone_forward(cfg, params, x, remat)
    Lc = cond.shape[1]
    h_audio = hidden[:, Lc:Lc + targets.shape[-1]]  # [B, T-1, d]
    logits = head_logits(params, h_audio).reshape(*h_audio.shape[:2], K, Vp).float()
    return logits, targets.transpose(1, 2)


def valid_targets(cfg: ZonosConfig, codes) -> int:
    """How many targets of raw ``codes [B, K, T]`` the loss counts: the
    delayed codes' non-mask entries after the first column."""
    delayed = apply_delay_pattern(torch.as_tensor(codes).long(), cfg.masked_token_id)
    return int((delayed[..., 1:] != cfg.masked_token_id).sum())


def multicodebook_loss(cfg: ZonosConfig, params: dict, cond: torch.Tensor, codes,
                       remat: bool = False, denom: int | None = None) -> torch.Tensor:
    """cond [B, Lc, d]; codes [B, K, T] raw (no delay) -> the scalar mean
    cross-entropy over every non-mask target (both backbones; ``remat``
    recomputes transformer layers in the backward pass).  ``denom``: the
    count to divide the sum by (a data rank's rows of a larger batch divide
    by the whole batch's :func:`valid_targets`), this batch's by default."""
    logits, tgt = teacher_forced_logits(cfg, params, cond, codes, remat)
    valid = tgt != cfg.masked_token_id
    tgt = tgt.clamp(0, cfg.padded_vocab_size - 1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * valid).sum() / (valid.sum().clamp_min(1) if denom is None else max(denom, 1))


def cfg_dropout_masks(specs, cond_inputs: dict, batch: int, uncond_p: float,
                      generator: torch.Generator) -> dict | None:
    """CFG dropout's per-row masks ``{name: bool [B]}`` for every conditioner
    with an uncond vector and an input: a joint mask (all of them take their
    uncond vectors together, the configuration CFG's uncond branch runs),
    then each conditioner's own mask, or-ed with it; drawn in that order,
    each ``uniform < uncond_p`` from ``generator`` (on its device)."""
    names = [s.name for s in specs if s.uncond and cond_inputs.get(s.name) is not None]
    if not names or uncond_p <= 0.0:
        return None

    def draw():
        return torch.rand(batch, generator=generator, device=generator.device) < uncond_p

    joint = draw()
    return {n: joint | draw() for n in names}


def conditioned_loss(cfg: ZonosConfig, specs, params: dict, cond_inputs: dict, codes,
                     generator: torch.Generator | None = None, uncond_p: float = 0.1,
                     remat: bool = False, uncond_drop: dict | None = None,
                     denom: int | None = None) -> torch.Tensor:
    """The loss from raw conditioning inputs (loader batches): the prefix
    conditioner runs inside the differentiated region, so its projections,
    embeddings and learned uncond vectors train.  ``uncond_drop`` (the masks
    of :func:`cfg_dropout_masks`) or, without it, masks drawn from
    ``generator`` at ``uncond_p``; neither: no dropout.  A conditioner whose
    input is None always uses its uncond vector, as inference's uncond
    branch does.  ``denom`` as :func:`multicodebook_loss`."""
    if uncond_drop is None and generator is not None:
        uncond_drop = cfg_dropout_masks(specs, cond_inputs, codes.shape[0], uncond_p, generator)
    cond = prefix_conditioner_forward(params["prefix_conditioner"], specs, cfg.prefix_conditioner,
                                      cond_inputs, cfg.backbone.norm_epsilon, uncond_drop)
    ref_dtype = tree_leaves(params["heads"])[0].dtype
    return multicodebook_loss(cfg, params, cond.to(ref_dtype), codes, remat=remat, denom=denom)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def _micro(x, i: int, mb: int):
    """Micro-batch ``i`` of ``x``; a batch-broadcast input (leading 1) or None
    passes through as it is."""
    if x is None or x.shape[0] == 1:
        return x
    return x[i * mb:(i + 1) * mb]


def _accumulated(loss_fn: Callable, params, accum_steps: int, batched: tuple, rest: tuple):
    """``(loss, gradient leaves)`` over ``accum_steps`` micro-batches of the
    ``batched`` arguments (each a tensor, an array or a dict of them): the
    mean loss and the mean gradient, accumulated in fp32 and cast to each
    parameter's dtype, as the JAX ``lax.scan`` does."""
    if accum_steps == 1:
        loss, grads = value_and_grad(loss_fn, params, *batched, *rest)
        return loss, _filled(grads, params)
    B = batched[-1].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
    mb = B // accum_steps
    leaves = tree_flatten(params)[0]
    acc = [None if p is None or not p.is_floating_point()
           else torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=params["embeddings"].device)
    for i in range(accum_steps):
        args = tuple({k: _micro(v, i, mb) for k, v in a.items()} if isinstance(a, dict)
                     else _micro(a, i, mb) for a in batched)
        loss, grads = value_and_grad(loss_fn, params, *args, *rest)
        loss_acc = loss_acc + loss / accum_steps
        for a, g in zip(acc, _filled(grads, params)):
            if a is not None:
                a.add_(g / accum_steps)
    return loss_acc, [None if a is None else a.to(p.dtype) for a, p in zip(acc, leaves)]


def _data_rows(mesh, x, batch: int):
    """This data rank's rows of ``x`` (a tensor, an array or a dict of them,
    whose leading axis is ``batch`` or a broadcast 1)."""
    from zonos_tpu_torch.parallel.sharding import batch_sharding

    rows = batch_sharding(mesh, batch)
    if isinstance(x, dict):
        return {k: _data_rows(mesh, v, batch) for k, v in x.items()}
    return x if x is None or x.shape[0] == 1 else x[rows]


def _data_sum(mesh, loss: torch.Tensor, grad_leaves: list) -> tuple[torch.Tensor, list]:
    """The loss and the gradients summed over the data axis, in place."""
    group = axis_group(mesh, "data")
    if group is None:
        return loss, grad_leaves
    import torch.distributed as dist

    loss = loss.clone()
    for t in [loss] + [g for g in grad_leaves if g is not None]:
        dist.all_reduce(t, group=group)
    return loss, grad_leaves


def rank_loss(cfg: ZonosConfig, specs, params: dict, cond_inputs: dict, codes,
              generator: torch.Generator | None, uncond_p: float, remat: bool, mesh=None
              ) -> torch.Tensor:
    """:func:`conditioned_loss` of a whole batch, or with ``mesh`` this data
    rank's part of it: its rows of the inputs and of the CFG dropout masks
    drawn for the whole batch, divided by the whole batch's valid count."""
    if mesh is None:
        return conditioned_loss(cfg, specs, params, cond_inputs, codes, generator, uncond_p, remat)
    B = codes.shape[0]
    masks = None if generator is None else cfg_dropout_masks(specs, cond_inputs, B, uncond_p,
                                                             generator)
    return conditioned_loss(cfg, specs, params, _data_rows(mesh, cond_inputs, B),
                            _data_rows(mesh, codes, B), None, uncond_p, remat,
                            uncond_drop=None if masks is None else _data_rows(mesh, masks, B),
                            denom=valid_targets(cfg, codes))


def _train_step(mesh, optimizer, loss_fn, accum_steps: int, batched: tuple, rest: tuple,
                  params, opt_state):
    with model_axis(axis_group(mesh, "model")):
        loss, grads = _accumulated(loss_fn, params, accum_steps, batched, rest)
        loss, grads = _data_sum(mesh, loss, grads)
        return _apply(optimizer, params, opt_state, grads) + (loss,)


def make_train_step(cfg: ZonosConfig, optimizer: "Optimizer", accum_steps: int = 1,
                    remat: bool = False, mesh=None):
    """One optimizer step over a precomputed prefix: ``(params, opt_state,
    cond, codes) -> (params, opt_state, loss)``.  ``accum_steps > 1`` splits
    the batch into that many micro-batches (activations exist for one at a
    time); the batch must divide evenly.  With ``mesh`` every rank passes
    the whole batch and its own shard of the parameters (module docstring)."""

    def loss_fn(params, cond, codes):
        if mesh is None:
            return multicodebook_loss(cfg, params, cond, codes, remat=remat)
        B = codes.shape[0]
        return multicodebook_loss(cfg, params, _data_rows(mesh, cond, B),
                                  _data_rows(mesh, codes, B), remat=remat,
                                  denom=valid_targets(cfg, codes))

    def train_step(params, opt_state, cond, codes):
        return _train_step(mesh, optimizer, loss_fn, accum_steps, (cond, codes), (), params,
                             opt_state)

    return train_step


def make_conditioned_train_step(cfg: ZonosConfig, specs, optimizer: "Optimizer",
                                uncond_p: float = 0.1, remat: bool = False,
                                accum_steps: int = 1, mesh=None):
    """One step over loader batches: ``(params, opt_state, cond_inputs, codes,
    generator) -> (params, opt_state, loss)``; ``generator`` draws the CFG
    dropout masks (None: no dropout).  ``accum_steps`` as
    :func:`make_train_step`; batch-broadcast conditioning inputs (leading 1)
    reach every micro-batch as they are.  With ``mesh`` every rank passes
    the whole batch, its own shard of the parameters and a generator in the
    same state (module docstring)."""

    def loss_fn(params, cond_inputs, codes, generator):
        return rank_loss(cfg, specs, params, cond_inputs, codes, generator, uncond_p, remat, mesh)

    def train_step(params, opt_state, cond_inputs, codes, generator=None):
        return _train_step(mesh, optimizer, loss_fn, accum_steps, (cond_inputs, codes),
                             (generator,), params, opt_state)

    return train_step


def make_conditioned_eval_fn(cfg: ZonosConfig, specs, remat: bool = False, mesh=None):
    """The held-out loss over loader batches, ``(params, cond_inputs, codes)
    -> scalar``, under ``no_grad`` and without CFG dropout: the conditioned
    model as inference's cond branch runs it (with ``mesh``, every rank the
    whole batch over its shard of the parameters)."""

    @torch.no_grad()
    def eval_fn(params, cond_inputs, codes):
        with model_axis(axis_group(mesh, "model")):
            return conditioned_loss(cfg, specs, params, cond_inputs, codes, None, 0.0, remat)

    return eval_fn


def _apply(optimizer: "Optimizer", params, opt_state, grad_leaves: list) -> tuple:
    _, rebuild = tree_flatten(params)
    updates, opt_state = optimizer.update(rebuild(grad_leaves), opt_state, params)
    return apply_updates(params, updates), opt_state


# ---------------------------------------------------------------------------
# Optimizers (optax's arithmetic)
# ---------------------------------------------------------------------------


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates,
    state)``: optax's ``GradientTransformation`` form.  A state is a dict of
    a host step count and trees mirroring the parameters."""

    init: Callable
    update: Callable


def apply_updates(params, updates):
    """``p + u`` in each parameter's dtype (``optax.apply_updates``)."""
    leaves, rebuild = tree_flatten(params)
    return rebuild([p if u is None else (p + u).to(p.dtype)
                    for p, u in zip(leaves, tree_flatten(updates)[0])])


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in fp32 arithmetic)."""
    return float(np.float32(x))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """``optax.linear_schedule``: fp32 ``(init - end) * (1 - c / steps) + end``
    with ``c`` clipped to [0, steps]."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return _f32(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine from ``peak_value`` to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``, in fp32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps}")

    def cosine(count: int) -> float:
        c = np.minimum(np.float32(count), np.float32(span))
        decay = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / np.float32(span)))
        decayed = np.float32(1 - alpha) * decay + np.float32(alpha)
        return _f32(np.float32(peak_value) * decayed)

    return lambda count: warmup(count) if count < warmup_steps else cosine(count - warmup_steps)


def _global_norm(grads: list[torch.Tensor], shards: list | None = None,
                 group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32 (on
    the device: no host read).  Over a model axis (``group``), the squares of
    the leaves ``shards`` marks sharded are summed across it; a replicated
    leaf counts once."""
    if group is None:
        total = None
        for g in grads:
            s = g.float().square().sum()
            total = s if total is None else total + s
        return total.sqrt()
    import torch.distributed as dist

    parts = [torch.zeros((), dtype=torch.float32, device=grads[0].device) for _ in range(2)]
    for g, shard in zip(grads, shards):
        parts[shard is not None] = parts[shard is not None] + g.float().square().sum()
    dist.all_reduce(parts[1], group=group)
    return (parts[0] + parts[1]).sqrt()


class _Axis(NamedTuple):
    """Where each leaf is sharded over a model axis: ``shards`` (a
    :class:`~zonos_tpu_torch.parallel.sharding.Shard` or None a leaf, in
    leaf order), the axis's ``group`` and ``size``."""

    shards: list
    group: object
    size: int

    def whole_shape(self, i: int, p: torch.Tensor) -> tuple[int, ...]:
        """Leaf ``i``'s shape before sharding."""
        shape, shard = list(p.shape), self.shards[i]
        if shard is not None:
            shape[shard.axis] *= self.size
        return tuple(shape)

    def mean(self, x: torch.Tensor, dim: int, sharded_dim: int | None) -> torch.Tensor:
        """``x.mean(dim)``, summed across the axis where ``dim`` is the
        sharded one (``sharded_dim``)."""
        if dim != sharded_dim:
            return x.mean(dim)
        import torch.distributed as dist

        total = x.sum(dim)
        dist.all_reduce(total, group=self.group)
        return total / (x.shape[dim] * self.size)


def optimizer_state_specs(opt_state: dict, params, specs, mesh,
                          min_dim_size_to_factor: int = 128) -> dict:
    """The spec tree of an optimizer state made for ``params`` (this rank's
    shard, whose spec tree is ``specs``): AdamW's moments shard as their
    leaves; Adafactor's full moment as its leaf, a row or column moment along
    the leaf's sharded axis where it keeps it, else whole.  Used to gather a
    state for a checkpoint and to cut a restored one."""
    from zonos_tpu_torch.parallel.sharding import Shard

    leaves, shards = tree_flatten(params)[0], tree_flatten(specs)[0]
    if "mu" in opt_state:
        return {k: (shards if k in ("mu", "nu") else None) for k in opt_state}
    axis = _Axis(shards, None, axis_size(mesh, "model"))
    rows, cols, full = [], [], []
    for i, (p, shard) in enumerate(zip(leaves, shards)):
        dims = None if p is None else _factored_dims(axis.whole_shape(i, p),
                                                     min_dim_size_to_factor)
        if dims is None:
            rows.append(None), cols.append(None), full.append(shard)
            continue
        r, c = _row_col_axes(shard, *dims)
        rows.append(None if r is None else Shard(r, shard.parts))
        cols.append(None if c is None else Shard(c, shard.parts))
        full.append(None)
    return {"count": None, "v_row": rows, "v_col": cols, "v": full}


def _row_col_axes(shard, d1: int, d0: int) -> tuple[int | None, int | None]:
    """The sharded axis of a factored leaf's row moment (its shape without
    ``d0``) and column moment (without ``d1``), None where it is whole."""
    a = None if shard is None else shard.axis
    row = None if a is None or a == d0 else a - (a > d0)
    col = None if a is None or a == d1 else a - (a > d1)
    return row, col


def _adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """optax ``scale_by_adam`` then ``add_decayed_weights``: per leaf
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu`` (the moments in the
    parameter's dtype), bias-corrected by ``1 - b^count`` (fp32, cast),
    ``mu_hat / (sqrt(nu_hat) + eps) + weight_decay p``."""

    def init(leaves):
        return {"mu": [None if p is None else torch.zeros_like(p) for p in leaves],
                "nu": [None if p is None else torch.zeros_like(p) for p in leaves]}

    def update(grads, state, leaves, count):
        c = np.float32(count + 1)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** c)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** c)
        out, mus, nus = [], [], []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], leaves):
            if g is None:
                out.append(None), mus.append(mu), nus.append(nu)
                continue
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g.square() + b2 * nu
            u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
            out.append(u + weight_decay * p)
            mus.append(mu), nus.append(nu)
        return out, {"mu": mus, "nu": nus}

    return init, update


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's choice: the two largest axes ``(d1, d0)`` of a tensor of at
    least 2 dimensions whose second largest has ``min_dim_size_to_factor``
    or more, else None (``np.argsort``, as optax sorts)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor(decay_rate=0.8, eps=1e-30, min_dim_size_to_factor=128, axis: _Axis | None = None):
    """optax ``scale_by_factored_rms`` (factored second moments: ``v_row``
    and ``v_col`` where :func:`_factored_dims` finds two large axes, a full
    ``v`` otherwise; decay ``1 - (count+1)^-0.8``), in the parameter's dtype.
    Over a model ``axis`` the factored axes come from each leaf's whole
    shape, and a mean over a sharded axis is taken across the axis."""

    def dims_of(i, p):
        shape = tuple(p.shape) if axis is None else axis.whole_shape(i, p)
        return _factored_dims(shape, min_dim_size_to_factor)

    def init(leaves):
        state = {"v_row": [], "v_col": [], "v": []}
        for i, p in enumerate(leaves):
            one = None if p is None else torch.zeros(1, dtype=p.dtype, device=p.device)
            dims = None if p is None else dims_of(i, p)
            if dims is None:
                row = col = one
                full = None if p is None else torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                row = torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype, device=p.device)
                col = torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype, device=p.device)
                full = one
            state["v_row"].append(row), state["v_col"].append(col), state["v"].append(full)
        return state

    def update(grads, state, leaves, count):
        t = np.float32(count + 1)
        d = np.float32(1) - t ** np.float32(-decay_rate)
        keep, take = _f32(d), _f32(np.float32(1) - d)
        out = []
        new = {"v_row": [], "v_col": [], "v": []}
        for i, (g, row, col, v, p) in enumerate(zip(grads, state["v_row"], state["v_col"],
                                                    state["v"], leaves)):
            if g is None:
                out.append(None)
                for k, x in (("v_row", row), ("v_col", col), ("v", v)):
                    new[k].append(x)
                continue
            sq = g.square() + eps
            dims = dims_of(i, p)
            if dims is None:
                v = (keep * v.float() + take * sq.float()).to(p.dtype)
                out.append(g * v ** -0.5)
            elif axis is not None:
                d1, d0 = dims
                a = None if axis.shards[i] is None else axis.shards[i].axis
                row_axis, _ = _row_col_axes(axis.shards[i], d1, d0)
                row = (keep * row.float() + take * axis.mean(sq.float(), d0, a)).to(p.dtype)
                col = (keep * col.float() + take * axis.mean(sq.float(), d1, a)).to(p.dtype)
                reduced = d1 - 1 if d1 > d0 else d1
                row_factor = (row / axis.mean(row, reduced, row_axis).unsqueeze(reduced)) ** -0.5
                out.append(g * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1))
            else:
                d1, d0 = dims
                row = (keep * row.float() + take * sq.float().mean(d0)).to(p.dtype)
                col = (keep * col.float() + take * sq.float().mean(d1)).to(p.dtype)
                reduced = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(reduced, keepdim=True)) ** -0.5
                out.append(g * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1))
            new["v_row"].append(row), new["v_col"].append(col), new["v"].append(v)
        return out, new

    return init, update


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01, warmup_steps: int = 0,
                   total_steps: int | None = None, grad_clip: float | None = 1.0,
                   kind: str = "adamw", mesh=None, specs=None) -> Optimizer:
    """Global-norm clipping, then AdamW or Adafactor, at a warmup-cosine
    schedule when ``total_steps`` is given, a linear warmup with
    ``warmup_steps`` alone, a constant ``lr`` otherwise
    (zonos_tpu/parallel/train.py:199-237).  Adafactor's factored second
    moment stores O(rows + cols) a matrix instead of AdamW's two moments of
    every parameter; its weight decay is added after the learning rate, as
    optax's ``adafactor`` adds it.  ``specs``: the spec tree of the trained
    parameters on ``mesh`` (``parallel/sharding.py``), read where its model
    axis has more than one rank; AdamW is elementwise and needs nothing of
    it."""
    axis = None
    if axis_size(mesh, "model") > 1 and specs is not None:
        axis = _Axis(tree_flatten(specs)[0], axis_group(mesh, "model"), axis_size(mesh, "model"))
    if total_steps is not None:
        schedule = warmup_cosine_decay_schedule(0.0, lr, max(warmup_steps, 1),
                                                max(total_steps, warmup_steps + 1))
    elif warmup_steps:
        schedule = linear_schedule(0.0, lr, warmup_steps)
    else:
        schedule = lambda count: lr  # noqa: E731
    if kind == "adamw":
        inner_init, inner = _adamw(weight_decay=weight_decay)
    elif kind == "adafactor":
        inner_init, inner = _adafactor(axis=axis)
    else:
        raise ValueError(f"unknown optimizer kind {kind!r}")

    def init(params) -> dict:
        return {"count": 0, **inner_init(tree_flatten(params)[0])}

    def update(grads, state: dict, params):
        grad_leaves, rebuild = tree_flatten(grads)
        leaves = tree_flatten(params)[0]
        if grad_clip is not None:
            live = [i for i, g in enumerate(grad_leaves) if g is not None]
            g_norm = _global_norm([grad_leaves[i] for i in live],
                                  None if axis is None else [axis.shards[i] for i in live],
                                  None if axis is None else axis.group)
            keep = g_norm < grad_clip
            grad_leaves = [None if g is None
                           else torch.where(keep, g, (g / g_norm.to(g.dtype)) * grad_clip)
                           for g in grad_leaves]
        count = state["count"]
        moments = {k: v for k, v in state.items() if k != "count"}
        out, moments = inner(grad_leaves, moments, leaves, count)
        step = schedule(count)
        if kind == "adamw":  # scale_by_learning_rate flips the sign
            out = [None if u is None else -step * u for u in out]
        else:  # the learning rate, then the decay, then scale(-1)
            out = [None if u is None else -(step * u + weight_decay * p if weight_decay
                                            else step * u) for u, p in zip(out, leaves)]
        return rebuild(out), {"count": count + 1, **moments}

    return Optimizer(init, update)
