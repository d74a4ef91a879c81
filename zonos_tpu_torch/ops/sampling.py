"""Token sampling pipeline (zonos_tpu/ops/sampling.py): repetition penalty
-> temperature softmax -> unified reshaping -> top-p -> top-k -> min-p ->
Gumbel-race draw (temperature 0 => greedy argmax).

The Gumbel noise is an operand, so tests can feed the JAX package's noise.
The decode loop draws it with :func:`keyed_gumbel`: a counter-based hash of
(the row's seed, the step, the draw, the element), all rows in a fixed
number of elementwise launches, with the step a tensor on the device, so
that a row's tokens depend on its own seed alone and a decode step reads
nothing back from the card.  This is JAX's design (``fold_in`` of the row's
seed, then a split per step) but not its stream: the same seeds give other
samples than the JAX package.  With ``top_p == top_k == 0`` the
pipeline is :func:`~zonos_tpu_torch.kernels.sampling.fused_sample`, which is
the K3 kernel on the card where it takes the operands (``kernel_takes``: a
vocabulary of at most 12,288), and its plain version elsewhere.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain, kernel_takes


trace_logger = logging.getLogger("zonos_tpu_torch.sampling.trace")

_TRACE_STATS = False
SUPPORT_FLOOR = 1e-6  # a token counts towards the support above this probability


def set_sampling_trace(on: bool) -> None:
    """Per-step sampling-distribution statistics (JAX's ``--verbose_sampling``,
    zonos_tpu/ops/sampling.py:40-62).  Read when a ``generate`` starts: its
    decode steps then write each step's per-codebook top probability,
    entropy and support into a buffer on the device (a CUDA graph's replay
    runs no host callback), and the host logs one line a step on
    ``zonos_tpu_torch.sampling.trace`` at its polls.  Off, the step
    computes and launches nothing for it."""
    global _TRACE_STATS
    _TRACE_STATS = bool(on)


def sampling_trace_on() -> bool:
    return _TRACE_STATS


@dataclass(frozen=True)
class SamplingParams:
    """Sampling hyperparameters (defaults match the JAX package's)."""

    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 0
    min_p: float = 0.0
    linear: float = 0.55
    conf: float = 0.4
    quad: float = 0.0
    repetition_penalty: float = 3.0
    repetition_penalty_window: int = 2
    # ban EOS in every codebook so each sample runs exactly its step budget
    ban_eos: bool = False

    @classmethod
    def greedy(cls) -> "SamplingParams":
        return cls(temperature=0.0, linear=0.0, conf=0.0, quad=0.0, repetition_penalty=1.0)


def apply_unified(probs: torch.Tensor, linear: float, conf: float, quad: float) -> torch.Tensor:
    """``raw = logp * (linear + H * conf) - logp^2 * quad``, then softmax."""
    logprobs = torch.log(torch.clamp(probs, min=1e-20))
    entropy = -torch.sum(probs * logprobs, dim=-1, keepdim=True)
    raw = logprobs * (linear + entropy * conf) - logprobs.square() * quad
    return torch.softmax(raw, dim=-1)


def apply_top_p(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Keep a sorted token while the cumulative mass above it is <= p."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    kept = torch.where((cum - sorted_probs) <= p, sorted_probs, torch.zeros_like(sorted_probs))
    out = torch.zeros_like(probs).scatter(-1, order, kept)
    return out / out.sum(dim=-1, keepdim=True)


def apply_top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest probs (ties at the pivot included), renormalize."""
    k = min(int(k), probs.shape[-1])
    pivot = torch.topk(probs, k, dim=-1).values[..., -1:]
    out = torch.where(probs < pivot, torch.zeros_like(probs), probs)
    return out / out.sum(dim=-1, keepdim=True)


def apply_min_p(probs: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens below ``min_p * max_prob``."""
    top = probs.amax(dim=-1, keepdim=True)
    out = torch.where(probs < min_p * top, torch.zeros_like(probs), probs)
    return out / out.sum(dim=-1, keepdim=True)


def apply_repetition_penalty(logits: torch.Tensor, generated_tokens: torch.Tensor,
                             penalty, window: int) -> torch.Tensor:
    """A token seen n times in the trailing ``window`` tokens is scaled by
    ``penalty**n`` (divide positive logits, multiply negative ones).
    ``logits`` [B, K, V]; ``generated_tokens`` [B, K, W]; ``penalty`` scalar
    or [B]."""
    V = logits.shape[-1]
    toks = torch.clamp(generated_tokens[..., -window:], 0, V - 1).long()
    # one_hot's count by comparison: no check of the ids' range on the host
    vocab = torch.arange(V, device=toks.device)
    counts = (toks[..., None] == vocab).sum(dim=-2).to(logits.dtype)  # [B, K, V]
    penalty = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)
    if penalty.dim() == 1:
        penalty = penalty[:, None, None]
    factors = torch.pow(penalty, counts)
    return torch.where(logits <= 0, logits * factors, logits / factors)


def categorical_race(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """argmax(log p + G) for Gumbel noise ``G`` of probs' shape."""
    scores = torch.where(probs > 0, torch.log(probs) + noise, torch.full_like(probs, float("-inf")))
    return torch.argmax(scores, dim=-1)


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)), u clamped to fp32's smallest normal first."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


_M32 = 0xFFFFFFFF
# a 32-bit multiply-xorshift finalizer whose multipliers lie below 2**31: each product of
# a 32-bit value stays below 2**63, so int64 tensor ops compute it exactly on any device
_MIX = ((16, 0x21F0AAAD), (15, 0x735A2D97), (15, None))
_DRAWS_PER_STEP = 8  # draw ids a step keys apart (below 8)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 32-bit values held in int64 (``[0, 2**32)`` in and out)."""
    for shift, mult in _MIX:
        x = x ^ (x >> shift)
        if mult is not None:
            x = (x * mult) & _M32
    return x


def row_keys(seeds: torch.Tensor) -> torch.Tensor:
    """Each row's 32-bit key from its int64 seed (both halves)."""
    return mix32((seeds & _M32) ^ mix32(((seeds >> 32) & _M32) ^ 0x3C6EF372))


def element_counters(n: int, device) -> torch.Tensor:
    """The mixed counters of ``n`` elements, ``[n]`` int64, a constant of the
    decode loop: mixing them once keeps two rows' streams from being one
    stream's elements in another order."""
    return mix32(torch.arange(n, dtype=torch.int64, device=device))


def keyed_bits(keys: torch.Tensor, step, draws: torch.Tensor,
               counters: torch.Tensor) -> torch.Tensor:
    """32 uniform bits ``[len(draws), B, n]`` int64 for row keys ``[B]`` at
    ``step`` (a 0-d int64 tensor or a host int) and ``draws`` ``[D]`` int64
    (below 8); the same (key, step, draw, element) always gives the same bits,
    on any device."""
    step_key = mix32(((step * _DRAWS_PER_STEP + draws) & _M32) ^ 0x1B873593)  # [D]
    key = mix32(keys[None, :] ^ step_key[:, None])  # [D, B]
    return mix32(key[:, :, None] ^ counters)


def keyed_gumbel(keys: torch.Tensor, step, draws: torch.Tensor, counters: torch.Tensor,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel noise ``[D, B, *shape]`` fp32 from :func:`keyed_bits`
    (``counters`` of ``prod(shape)`` elements): u = the top 24 bits / 2**24."""
    bits = keyed_bits(keys, step, draws, counters)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return gumbel_of_uniform(u).reshape(draws.shape[0], keys.shape[0], *shape)


def _penalized(logits: torch.Tensor, p: "SamplingParams", generated_tokens, repetition_penalty):
    """``logits`` after the repetition penalty, where the params ask for it."""
    if generated_tokens is not None and p.repetition_penalty_window > 0:
        if p.repetition_penalty != 1.0 or repetition_penalty is not None:
            rp = p.repetition_penalty if repetition_penalty is None else repetition_penalty
            logits = apply_repetition_penalty(logits, generated_tokens, rp,
                                              p.repetition_penalty_window)
    return logits


def sampling_probs(logits: torch.Tensor, params: "SamplingParams",
                   generated_tokens: torch.Tensor | None = None,
                   repetition_penalty: torch.Tensor | None = None) -> torch.Tensor:
    """The distribution a sampled draw races over, in the plain math of
    JAX's unfused path (which its trace logs): the penalty, softmax at the
    temperature, unified, top-p, top-k, min-p; fp32 ``[B, K, V]``."""
    p = params
    logits = _penalized(logits, p, generated_tokens, repetition_penalty)
    probs = torch.softmax(logits.float() / p.temperature, dim=-1)
    if p.linear > 0:
        probs = apply_unified(probs, p.linear, p.conf, p.quad)
    if p.top_p > 0:
        probs = apply_top_p(probs, p.top_p)
    if p.top_k > 0:
        probs = apply_top_k(probs, p.top_k)
    if p.min_p > 0:
        probs = apply_min_p(probs, p.min_p)
    return probs


def prob_stats(probs: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` fp32: each distribution's top probability, entropy (of its
    nonzero entries) and support (entries above SUPPORT_FLOOR), as JAX's
    ``_emit_prob_stats`` computes them on the host."""
    ent = -torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs)).sum(-1)
    support = (probs > SUPPORT_FLOOR).sum(-1).to(torch.float32)
    return torch.stack([probs.amax(-1), ent, support], dim=-1)


def log_prob_stats(stats: np.ndarray) -> None:
    """One trace line of a step's ``[B, K, 3]`` statistics, in JAX's format."""
    trace_logger.debug(
        "probs: top=%s entropy=%s support=%s",
        np.round(stats[..., 0], 4).tolist(),
        np.round(stats[..., 1], 3).tolist(),
        stats[..., 2].astype(np.int64).tolist(),
    )


def sample_from_logits(
    logits: torch.Tensor,
    params: SamplingParams,
    noise: torch.Tensor | None = None,
    generated_tokens: torch.Tensor | None = None,
    repetition_penalty: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample ids ``[B, K]`` from logits ``[B, K, V]``.  ``noise`` is Gumbel
    noise of logits' shape (unused at temperature 0).  ``repetition_penalty``
    overrides the static penalty with a per-sample ``[B]`` tensor."""
    p = params
    logits = _penalized(logits, p, generated_tokens, repetition_penalty)

    if p.temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs Gumbel noise")

    if p.top_p == 0 and p.top_k == 0:
        logits = logits.float().contiguous()
        # K3 where it takes the operands (on the card; a CPU tensor takes the plain version)
        sample = fused_sample if kernel_takes(logits, noise) else fused_sample_plain
        return sample(logits, noise, linear=p.linear, conf=p.conf, quad=p.quad, min_p=p.min_p,
                      temperature=p.temperature)

    probs = torch.softmax(logits / p.temperature, dim=-1)
    if p.linear > 0:
        probs = apply_unified(probs, p.linear, p.conf, p.quad)
    if p.top_p > 0:
        probs = apply_top_p(probs, p.top_p)
    if p.top_k > 0:
        probs = apply_top_k(probs, p.top_k)
    if p.min_p > 0:
        probs = apply_min_p(probs, p.min_p)
    return categorical_race(probs, noise)
