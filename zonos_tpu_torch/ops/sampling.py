"""Token sampling pipeline (zonos_tpu/ops/sampling.py): repetition penalty
-> temperature softmax -> unified reshaping -> top-p -> top-k -> min-p ->
Gumbel-race draw (temperature 0 => greedy argmax).

The Gumbel noise is an operand: the caller draws it from its own
``torch.Generator``, so a row's tokens depend on its own stream alone and
tests can feed the JAX package's noise.  With ``top_p == top_k == 0`` the
pipeline is :func:`~zonos_tpu_torch.kernels.sampling.fused_sample`, which is
the K3 kernel on the card where it takes the operands (``kernel_takes``: a
vocabulary of at most 12,288), and its plain version elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain, kernel_takes


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
    counts = F.one_hot(toks, V).sum(dim=-2).to(logits.dtype)  # [B, K, V]
    penalty = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)
    if penalty.dim() == 1:
        penalty = penalty[:, None, None]
    factors = torch.pow(penalty, counts)
    return torch.where(logits <= 0, logits * factors, logits / factors)


def categorical_race(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """argmax(log p + G) for Gumbel noise ``G`` of probs' shape."""
    scores = torch.where(probs > 0, torch.log(probs) + noise, torch.full_like(probs, float("-inf")))
    return torch.argmax(scores, dim=-1)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


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
    if generated_tokens is not None and p.repetition_penalty_window > 0:
        if p.repetition_penalty != 1.0 or repetition_penalty is not None:
            rp = p.repetition_penalty if repetition_penalty is None else repetition_penalty
            logits = apply_repetition_penalty(logits, generated_tokens, rp,
                                              p.repetition_penalty_window)

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
