"""Zonos TTS orchestration: conditioning -> prefill -> AR decode -> codes.

The semantics of zonos_tpu/models/tts.py (``build_generate_parts`` and
``Zonos.generate``): 9-codebook summed embeddings, one fused head matmul,
classifier-free guidance over 2B rows (dropped when ``cfg_scale == 1``),
the delay pattern, the EOS choreography (resample once on first EOS with EOS
banned, a 6-step silence window, staircase EOS placement), the per-sample
repetition penalty switched off in EOS mode, per-row step limits and seeds,
and the same output trim.

The decode loop is a Python loop over torch ops.  It never waits for the
card inside a step: the position is a host int (all rows advance in
lockstep), and the host reads ``remaining`` once every 32 steps.  Steps run
after every row has finished are no-ops, because each state update is gated
on a device-side ``any(remaining > 0)``; so the final offset, and with it
the output length, is the one the JAX ``while_loop`` reaches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zonos_tpu_torch.conditioning import (
    build_specs,
    init_prefix_conditioner_params,
    prefix_conditioner_forward,
    prepare_cond_inputs,
    required_keys,
)
from zonos_tpu_torch.config import ZonosConfig, find_multiple
from zonos_tpu_torch.models.backbone import (
    KVCache,
    init_transformer_params,
    transformer_decode_step,
    transformer_prefill,
)
from zonos_tpu_torch.ops.delay import apply_delay_pattern, revert_delay_pattern
from zonos_tpu_torch.ops.eos import EosState, eos_logit_mask, eos_update
from zonos_tpu_torch.ops.sampling import SamplingParams, gumbel_noise, sample_from_logits
from zonos_tpu_torch.utils.device import resolve_device

UNKNOWN_TOKEN = -1
MAX_STEPS_AFTER_EOS = 6  # ~70 ms of silence after EOS
SYNC_INTERVAL = 32  # decode steps between host reads of `remaining`


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------


def init_embed_head_params(cfg: ZonosConfig, generator: torch.Generator,
                           dtype=torch.bfloat16, device="cpu") -> dict:
    d = cfg.backbone.d_model
    K, Vp = cfg.num_codebooks, cfg.padded_vocab_size
    emb = torch.randn((K, Vp, d), generator=generator, device=device) * 0.02
    heads = torch.randn((d, K * Vp), generator=generator, device=device) / math.sqrt(d)
    # the vocab padding is dead weight: zero it, as checkpoint loads do
    emb[:, cfg.input_vocab_size:, :] = 0.0
    cols = torch.arange(K * Vp, device=device) % Vp >= cfg.output_vocab_size
    heads[:, cols] = 0.0
    return {"embeddings": emb.to(dtype), "heads": heads.to(dtype)}


def embed_codes(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """Sum the 9 per-codebook embeddings: codes [B, K, S] -> [B, S, d]."""
    K = codes.shape[1]
    tables = params["embeddings"]  # [K, Vp, d]
    cb = torch.arange(K, device=codes.device)[None, :, None]
    return tables[cb, codes].sum(dim=1)


def apply_heads(params: dict, cfg: ZonosConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, d] -> fp32 logits [B, K, V_pad] via one fused [d, K*V_pad] matmul."""
    logits = hidden @ params["heads"]
    return logits.reshape(hidden.shape[0], cfg.num_codebooks, cfg.padded_vocab_size).float()


def cfg_blend(logits: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """Classifier-free guidance over a [2B, ...] cond/uncond stack."""
    B = logits.shape[0] // 2
    cond, uncond = logits[:B], logits[B:]
    return uncond + (cond - uncond) * cfg_scale


def _mask_invalid(logits: torch.Tensor, output_vocab: int) -> torch.Tensor:
    """-inf above the real output vocab (EOS = 1024 is the last valid id)."""
    V = logits.shape[-1]
    invalid = torch.arange(V, device=logits.device) >= output_vocab
    return logits.masked_fill(invalid, float("-inf"))


def _compute_step_logits(params, cfg, hidden, cfg_scale, use_cfg):
    logits = apply_heads(params, cfg, hidden)
    if use_cfg:
        logits = cfg_blend(logits, cfg_scale)
    return _mask_invalid(logits, cfg.output_vocab_size)


# ---------------------------------------------------------------------------
# Public model class
# ---------------------------------------------------------------------------


class Zonos:
    """User-facing model: ``prepare_conditioning`` then ``generate``.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    ``device="cpu"`` runs the plain versions of the kernels.  ``params``
    (for example from :mod:`zonos_tpu_torch.convert`) or a random init from
    ``seed``; the compute dtype is the embeddings' dtype.
    """

    def __init__(self, config: ZonosConfig, params: dict | None = None, seed: int = 0,
                 device: str | torch.device = "cuda", dtype=torch.bfloat16):
        if not config.backbone.is_transformer:
            raise NotImplementedError("the port runs the transformer backbone only")
        self.config = config
        self.device = resolve_device(device)
        self.specs = build_specs(config.prefix_conditioner, config.backbone.d_model)
        self.eos_token_id = config.eos_token_id
        self.masked_token_id = config.masked_token_id
        if params is None:
            params = self.init_params(seed, dtype)
        self.params = params

    def init_params(self, seed: int, dtype=torch.bfloat16) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg = self.config
        d = cfg.backbone.d_model
        p = {
            "backbone": init_transformer_params(cfg.backbone, gen, dtype, self.device),
            "prefix_conditioner": init_prefix_conditioner_params(
                gen, cfg.prefix_conditioner, d, dtype, self.device),
        }
        p.update(init_embed_head_params(cfg, gen, dtype, self.device))
        return p

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.params["embeddings"].dtype

    # -- conditioning ----------------------------------------------------
    def prepare_conditioning(self, cond_dict: dict, uncond_dict: dict | None = None,
                             pad_to_multiple: int = 1) -> torch.Tensor:
        """-> [2B, cond_len, d_model]: the cond prefix stacked over the uncond one."""
        if uncond_dict is None:
            uncond_dict = {k: cond_dict[k] for k in required_keys(self.specs) if k in cond_dict}
        pp = self.params["prefix_conditioner"]
        pc = self.config.prefix_conditioner
        eps = self.config.backbone.norm_epsilon
        cond = prefix_conditioner_forward(
            pp, self.specs, pc, prepare_cond_inputs(self.specs, cond_dict, pad_to_multiple), eps)
        uncond = prefix_conditioner_forward(
            pp, self.specs, pc, prepare_cond_inputs(self.specs, uncond_dict, pad_to_multiple), eps)
        B = max(cond.shape[0], uncond.shape[0])
        dtype = torch.promote_types(cond.dtype, uncond.dtype)
        return torch.cat([cond.expand(B, *cond.shape[1:]).to(dtype),
                          uncond.expand(B, *uncond.shape[1:]).to(dtype)], dim=0)

    # -- generation ------------------------------------------------------
    def _row_generators(self, seed, batch_size: int) -> list[torch.Generator]:
        """One generator per row, seeded from that row's seed alone; a scalar
        seed fans out as ``seed + row``."""
        seeds = np.asarray(seed, np.int64)
        if seeds.ndim == 0:
            seeds = int(seeds) + np.arange(batch_size, dtype=np.int64)
        elif seeds.shape != (batch_size,):
            raise ValueError(f"seed must be a scalar or length-{batch_size} "
                             f"sequence, got shape {seeds.shape}")
        return [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def _noise(self, gens: list[torch.Generator], draws: int) -> torch.Tensor:
        """[draws, B, K, V_pad] Gumbel noise; row i from its own generator."""
        K, Vp = self.config.num_codebooks, self.config.padded_vocab_size
        rows = [gumbel_noise((draws, K, Vp), g, self.device) for g in gens]
        return torch.stack(rows, dim=1)

    @torch.inference_mode()
    def generate(
        self,
        prefix_conditioning: torch.Tensor,  # [2B, cond_len, d_model]
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        batch_size: int = 1,
        sampling_params: dict | SamplingParams | None = None,
        seed=423,
        step_limits: np.ndarray | list[int] | int | None = None,
    ) -> list[np.ndarray]:
        """Sample DAC codes; returns a list of per-sample [K, T_i] int arrays
        (EOS-trimmed).  ``step_limits`` caps new frames per sample (or for
        all); ``seed`` is a scalar or one seed per sample."""
        cfg = self.config
        K = cfg.num_codebooks
        eos_id, mask_id = cfg.eos_token_id, cfg.masked_token_id
        B = batch_size
        if prefix_conditioning.shape[0] != 2 * B:
            raise ValueError(f"prefix_conditioning batch {prefix_conditioning.shape[0]} != 2*{B}")
        sampling = sampling_params
        if sampling is None:
            sampling = SamplingParams()
        elif isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        # at cfg_scale == 1 the blend is the cond logits: drop the uncond half
        use_cfg = float(cfg_scale) != 1.0
        prefix = prefix_conditioning if use_cfg else prefix_conditioning[:B]
        prefix = prefix.to(self.device, self.compute_dtype)
        params, bp = self.params, self.params["backbone"]
        dev = self.device

        cond_len = prefix.shape[1]
        audio_len = max_new_tokens
        total_seq = find_multiple(cond_len + audio_len + K, 64)
        window = max(sampling.repetition_penalty_window, 1)
        prefill_len = 1
        cache = KVCache.create(cfg.backbone, prefix.shape[0], total_seq, self.compute_dtype, dev)
        gens = self._row_generators(seed, B)
        sampled = sampling.temperature > 0

        codes = torch.full((B, K, audio_len), UNKNOWN_TOKEN, dtype=torch.int64, device=dev)
        delayed = apply_delay_pattern(codes, mask_id)  # [B, K, audio_len + K]

        # ---- prefill over the text prefix + the first delayed frame -------
        audio_embeds = embed_codes(params, delayed[..., :prefill_len])
        if use_cfg:
            audio_embeds = audio_embeds.repeat(2, 1, 1)
        x = torch.cat([prefix, audio_embeds.to(prefix.dtype)], dim=1)
        hidden, cache = transformer_prefill(cfg.backbone, bp, x, cache)
        logits = _compute_step_logits(params, cfg, hidden[:, -1], cfg_scale, use_cfg)
        if sampling.ban_eos:
            logits[:, :, eos_id] = float("-inf")
        noise = self._noise(gens, 1)[0] if sampled else None
        first = sample_from_logits(logits, sampling, noise)
        frame = delayed[..., prefill_len]
        delayed[..., prefill_len] = torch.where(frame == UNKNOWN_TOKEN, first, frame)

        max_steps = delayed.shape[2] - prefill_len
        remaining = torch.full((B,), max_steps, dtype=torch.int32, device=dev)
        if step_limits is not None:
            lim = torch.tensor(np.broadcast_to(np.asarray(step_limits, np.int64), (B,)),
                               dtype=torch.int32, device=dev)
            remaining = torch.minimum(remaining, lim + (K - 1))
        state = EosState.init(B, max_steps, MAX_STEPS_AFTER_EOS, dev)._replace(remaining=remaining)
        offset = torch.tensor(prefill_len, dtype=torch.int64, device=dev)

        # EOS down-weighting bias; with ban_eos codebook 0's EOS is -inf too
        bias = torch.zeros((K, cfg.padded_vocab_size), dtype=torch.float32, device=dev)
        bias[1:, eos_id] = float("-inf")
        bias[0, eos_id] = float("-inf") if sampling.ban_eos else -math.log(1024.0)

        pos0 = cond_len + prefill_len  # cache row of the first decode step
        for step in range(max_steps):
            if step and step % SYNC_INTERVAL == 0 and int(state.remaining.max()) <= 0:
                break
            active = state.remaining.max() > 0  # device bool: the while_loop's cond
            off = prefill_len + step + 1  # == offset + 1 while active
            # a step after every row finished may read an unfilled (-1) column;
            # its result is discarded, but the gather must not see -1
            h = embed_codes(params, delayed[..., off - 1:off].clamp_min(0))
            if use_cfg:
                h = h.repeat(2, 1, 1)
            hidden, cache = transformer_decode_step(cfg.backbone, bp, h, cache, pos0 + step)
            logits = _compute_step_logits(params, cfg, hidden[:, -1], cfg_scale, use_cfg) + bias

            # per-sample repetition penalty, 1.0 in EOS mode
            rp = torch.where(state.eos_mode, torch.ones((), device=dev),
                             torch.full((), sampling.repetition_penalty, device=dev))
            logits, masked_state = eos_logit_mask(state, logits, eos_id)
            start = max(off - window, 0)
            gen_window = delayed[..., start:start + window]
            noise = self._noise(gens, 2) if sampled else (None, None)
            token = sample_from_logits(logits, sampling, noise[0], gen_window, rp)
            # the first-EOS substitute frame, sampled with EOS banned
            banned = logits.clone()
            banned[:, 0, eos_id] = float("-inf")
            token2 = sample_from_logits(banned, sampling, noise[1], gen_window, rp)
            token, new_state = eos_update(masked_state, token, token2, eos_id, mask_id, K,
                                          MAX_STEPS_AFTER_EOS)

            # the last step writes past the buffer; clamp like dynamic_update_slice
            col = min(off, delayed.shape[2] - 1)
            frame = delayed[..., col]
            merged = torch.where(frame == UNKNOWN_TOKEN, token, frame)
            delayed[..., col] = torch.where(active, merged, frame)
            state = EosState(*(torch.where(active, new, old)
                               for new, old in zip(new_state, state)))
            offset += active.to(offset.dtype)

        return self._trim(delayed.cpu().numpy(), int(offset), step_limits)

    def _trim(self, delayed: np.ndarray, offset: int, step_limits) -> list[np.ndarray]:
        """Revert the delay, cut at ``offset - K``, then per sample at the first
        codebook-0 EOS and at its step limit."""
        K = self.config.num_codebooks
        out = revert_delay_pattern(delayed)
        # first EOS per sample in codebook 0; 0 (no hit, or a hit at frame 0)
        # means full length
        eos_pos = (out[:, 0, :] == self.eos_token_id).argmax(axis=1)
        eos_pos[eos_pos == 0] = out.shape[2]
        out = out[..., : offset - K]
        out = np.where(out >= self.config.codebook_size, 0, out)
        limits = (None if step_limits is None
                  else np.broadcast_to(np.asarray(step_limits, np.int64), (out.shape[0],)))
        results = []
        for i in range(out.shape[0]):
            end = min(int(eos_pos[i]), out.shape[2])
            if limits is not None:
                end = min(end, int(limits[i]))
            results.append(out[i, :, :end].copy())
        return results
