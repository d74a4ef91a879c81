"""Zonos TTS orchestration: conditioning -> prefill -> AR decode -> codes.

The semantics of zonos_tpu/models/tts.py (``build_generate_parts`` and
``Zonos.generate``): 9-codebook summed embeddings, one fused head matmul,
classifier-free guidance over 2B rows (dropped when ``cfg_scale == 1``),
the delay pattern, the EOS choreography (resample once on first EOS with EOS
banned, a 6-step silence window, staircase EOS placement), the per-sample
repetition penalty switched off in EOS mode, per-row step limits and seeds,
the same output trim, and an audio prefix (DAC codes of a voice to continue)
prefilled after the conditioning and cut from the result.

The decode step is one function over tensors on the model's device, the
counterpart of the carry of the JAX ``while_loop`` (zonos_tpu/models/tts.py
``build_generate_parts``): the delayed codes, the cache, the EOS state, the
step index, the offset and the row keys are read and written in place, the
position, the input column, the repetition window and the column written
are gathered on the device, and the Gumbel noise is keyed by (row seed,
step, draw).  So a step never reads a value back to the host.  On the CPU
the host calls it step by step; on the card ``generate`` runs it once
eagerly (every kernel library loaded, every kernel attribute set), captures
it into a CUDA graph once per band of cache lengths (the band fixes K1/K2's
launches) and replays the graph at every step.  The host reads ``remaining``
once every 32 steps.  Steps run after every row has finished are no-ops,
because each state update is gated on a device-side ``any(remaining > 0)``;
so the final offset, and with it the output length, is the one the JAX
``while_loop`` reaches.

Streaming (``stream_generate_batch``) runs the same prefill and the same
decode steps (replays on the card) in chunks of ``chunk_frames`` steps and
vocodes each chunk's final codes with the DAC's receptive field as margin,
so that the concatenated chunks equal the full decode of the same codes.

On a ``("data", "model")`` mesh (:meth:`Zonos.shard`; one process a device,
``parallel/mesh.py``) every rank calls ``generate`` with the same whole
arguments and gets the same whole result: data rank r decodes requests
``[r B/n, (r+1) B/n)`` (and their uncond rows ``B + i``, each row's noise
keyed by its global row), the ranks of the model axis share each layer's
heads and the heads' vocabulary (``ops/tp.py``), and the
trimmed codes are gathered over the data axis.  At each poll the ranks agree
on the steps left and on the callback's verdict, so all of them run the same
number of steps.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Callable

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
from zonos_tpu_torch.kernels import add_launches, launch_counts, launches_since
from zonos_tpu_torch.kernels.decode_attention import Band, band_of
from zonos_tpu_torch.models.backbone import KV_STORAGE
from zonos_tpu_torch.models.hybrid import ssm_state_mode
from zonos_tpu_torch.models.registry import backbone_ops
from zonos_tpu_torch.ops.delay import apply_delay_pattern, revert_delay_pattern
from zonos_tpu_torch.ops.attention import StepPosition
from zonos_tpu_torch.ops.eos import EosState, eos_logit_mask, eos_update
from zonos_tpu_torch.ops.quant import matmul_w, quantize_weight_int4, quantize_weight_int8
from zonos_tpu_torch.ops.tp import (
    axis_group,
    axis_size,
    copy_to_model,
    gather_from_model,
    gather_objects,
    mesh_shape,
    model_axis,
    world_of,
)
from zonos_tpu_torch.ops.sampling import (
    SamplingParams,
    element_counters,
    keyed_gumbel,
    log_prob_stats,
    prob_stats,
    row_keys,
    sample_from_logits,
    sampling_probs,
    sampling_trace_on,
)
from zonos_tpu_torch.utils.device import resolve_device

UNKNOWN_TOKEN = -1
MAX_STEPS_AFTER_EOS = 6  # ~70 ms of silence after EOS
SYNC_INTERVAL = 32  # decode steps between host reads of `remaining`
STEP_DRAWS = 2  # a step's keyed-noise draws: 0 the token, 1 the EOS-banned substitute
PREFILL_DRAW = 2  # the prefill's draw, keyed apart from a step's


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


def head_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., d] @ the fused [d, K*V_pad] heads (a plain, int8 or int4
    weight).  On a model axis each rank runs its vocab columns and the
    logits are gathered: every rank gets all K*V_pad of them."""
    return gather_from_model(matmul_w(copy_to_model(hidden), params["heads"]))


def apply_heads(params: dict, cfg: ZonosConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, d] -> fp32 logits [B, K, V_pad] via one fused [d, K*V_pad]
    matmul (a plain, int8 or int4 weight)."""
    logits = head_logits(params, hidden)
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


def repetition_window(delayed: torch.Tensor, off: torch.Tensor, window: int,
                      window_cols: torch.Tensor) -> torch.Tensor:
    """``delayed[..., start:start + window]`` with ``start = max(off - window,
    0)``, gathered at the device's ``off`` (0-d int64); ``window_cols`` is
    ``arange(min(window, T))``, the slice's length."""
    start = (off - window).clamp_min(0)
    return delayed.index_select(2, start + window_cols)


def write_frame(delayed: torch.Tensor, off: torch.Tensor, token: torch.Tensor,
                active: torch.Tensor) -> None:
    """Fill column ``min(off, T - 1)`` of ``delayed`` [B, K, T] (the last step
    writes past the buffer; clamp like dynamic_update_slice) with ``token``
    [B, K] where it is still unknown, if ``active``; in place, at the device's
    ``off``."""
    col = off.clamp_max(delayed.shape[2] - 1).reshape(1)
    frame = delayed.index_select(2, col)[..., 0]
    merged = torch.where(frame == UNKNOWN_TOKEN, token, frame)
    delayed.index_copy_(2, col, torch.where(active, merged, frame)[..., None])


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

    ``config`` describes the transformer or the Mamba2 hybrid; the backbone's
    init, cache, prefill and decode step come from ``models/registry.py``.
    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    ``device="cpu"`` runs the plain versions of the kernels.  ``params``
    (for example from :mod:`zonos_tpu_torch.convert`) or a random init from
    ``seed``; the compute dtype is the embeddings' dtype.

    Serving modes: :meth:`quantize_int8` / :meth:`quantize_int4` quantize the
    backbone's projections and the heads in place; :meth:`set_storage` picks
    the KV-cache storage (transformer) and the SSM-state storage (hybrid) of
    later ``generate`` calls.  :meth:`shard` keeps this rank's shard of the
    parameters on a ``("data", "model")`` mesh (quantize before sharding).
    """

    def __init__(self, config: ZonosConfig, params: dict | None = None, seed: int = 0,
                 device: str | torch.device = "cuda", dtype=torch.bfloat16):
        self.config = config
        self.backbone = backbone_ops(config.backbone)
        self.device = resolve_device(device)
        self.specs = build_specs(config.prefix_conditioner, config.backbone.d_model)
        self.eos_token_id = config.eos_token_id
        self.masked_token_id = config.masked_token_id
        if params is None:
            params = self.init_params(seed, dtype)
        self.params = params
        self.storage = {"kv": None, "ssm": None}
        self.mesh = None  # the (data, model) mesh of :meth:`shard`
        # the last generate's decode: steps run, CUDA graphs captured, capture seconds,
        # the mesh, and why the steps ran eagerly on the card (None: they did not)
        self.decode_stats: dict | None = None
        self._autoencoder = None
        self._spk_tower = None

    def init_params(self, seed: int, dtype=torch.bfloat16) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg = self.config
        d = cfg.backbone.d_model
        p = {
            "backbone": self.backbone.init(cfg.backbone, gen, dtype, self.device),
            "prefix_conditioner": init_prefix_conditioner_params(
                gen, cfg.prefix_conditioner, d, dtype, self.device),
        }
        p.update(init_embed_head_params(cfg, gen, dtype, self.device))
        return p

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.params["embeddings"].dtype

    def shard(self, mesh) -> "Zonos":
        """Keep this rank's shard of the parameters on ``mesh``
        (``parallel/sharding.py``: attention heads, MLP hidden units and the
        heads' vocabulary on ``"model"``, section by section; the rest
        replicated) and run later calls on it (zonos_tpu/models/tts.py:455-466):
        batches split along ``"data"``, each layer's partial products summed
        over ``"model"``.  Every rank calls this, then the same entry points
        with the same arguments."""
        from zonos_tpu_torch.parallel.sharding import shard_params

        self.params = shard_params(mesh, self.params, self.config)
        self.mesh = mesh
        return self

    @classmethod
    def from_local(cls, config_path: str, model_path: str | None = None,
                   device: str | torch.device = "cuda", dtype=torch.bfloat16,
                   mesh=None) -> "Zonos":
        """A model from reference-format files (zonos_tpu/models/tts.py:468-489):
        the parameters are built from ``model_path`` on ``device``, every
        leaf in ``dtype`` (``utils/checkpoint.py``); without ``model_path``
        a random init from seed 0.  With ``mesh`` each weight is cut to this
        rank's shard before it moves to the device (no whole replica of a
        sharded weight there)."""
        from zonos_tpu_torch.utils.checkpoint import load_zonos_checkpoint

        device = resolve_device(device)
        cfg = ZonosConfig.from_json(config_path)
        if model_path is None:
            model = cls(cfg, device=device, dtype=dtype)
            return model if mesh is None else model.shard(mesh)
        model = cls(cfg, params=load_zonos_checkpoint(cfg, model_path, device, dtype, mesh=mesh),
                    device=device, dtype=dtype)
        model.mesh = mesh
        return model

    @classmethod
    def from_pretrained(cls, repo_id: str, device: str | torch.device = "cuda",
                        dtype=torch.bfloat16, mesh=None) -> "Zonos":
        """``config.json`` and ``model.safetensors`` of ``repo_id`` from the
        local models directory (``utils/hub.py``; nothing is downloaded)."""
        from zonos_tpu_torch.utils.hub import hub_download

        return cls.from_local(hub_download(repo_id, "config.json"),
                              hub_download(repo_id, "model.safetensors"), device, dtype,
                              mesh=mesh)

    @property
    def _model_group(self):
        return axis_group(self.mesh, "model")

    def _eager_reason(self) -> str | None:
        """Why the card's decode steps cannot be CUDA graphs, or None: a
        model axis on gloo, whose collectives a capture cannot hold (a data
        axis has no collective inside a step; NCCL's are captured)."""
        group = self._model_group
        if group is not None and torch.distributed.get_backend(group) != "nccl":
            return "gloo model axis"
        return None

    def _graphs_on(self) -> bool:
        return self.device.type == "cuda" and self._eager_reason() is None

    @property
    def autoencoder(self):
        """The DAC codec on the model's device, built at first use: the
        ``descript/dac_44khz`` checkpoint from the models directory, or
        random weights from seed 0 without it (zonos_tpu/models/tts.py:493-498);
        set ``_autoencoder`` to use another."""
        if self._autoencoder is None:
            from zonos_tpu_torch.models.dac import DACAutoencoder

            self._autoencoder = DACAutoencoder(device=self.device)
        return self._autoencoder

    def make_speaker_embedding(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """A reference clip -> the ``[1, 1, 128]`` float32 LDA speaker
        embedding ``make_cond_dict(speaker=...)`` takes
        (zonos_tpu/models/tts.py:500-509); the tower, built at first use from
        the models directory's speaker checkpoints, runs on the model's device."""
        if self._spk_tower is None:
            from zonos_tpu_torch.models.speaker import SpeakerEmbeddingLDA

            self._spk_tower = SpeakerEmbeddingLDA(device=self.device)
        _, lda = self._spk_tower(wav, sr)
        return np.asarray(lda, np.float32).reshape(1, 1, -1)

    # -- serving modes ---------------------------------------------------
    def quantize_int8(self) -> "Zonos":
        """Per-output-channel int8 weights for the backbone's projections and
        the heads (zonos_tpu/models/tts.py:407); embeddings, norms and the
        conditioner stay as they are."""
        return self._quantize(quantize_weight_int8)

    def quantize_int4(self, group_size: int = 128) -> "Zonos":
        """Group-wise int4 weights (two per byte, one bf16 scale per
        ``group_size`` rows and column) for the same weights as int8; a
        weight whose in-dim the groups do not divide stays as it is."""
        return self._quantize(lambda w: quantize_weight_int4(w, group_size))

    def _quantize(self, qfn) -> "Zonos":
        if axis_size(self.mesh, "model") > 1:
            # a row-parallel weight's scales (and an int4 one whole) come from all its rows
            raise ValueError("quantize the whole model, then shard it")

        def q_or_keep(w):
            try:
                return qfn(w)
            except ValueError:  # e.g. int4 group_size does not divide this dim
                return w

        bp = self.params["backbone"]
        if self.config.backbone.is_transformer:
            layers = dict(bp["layers"])
            for name in ("wqkv", "wo", "w1", "w2"):
                layers[name] = q_or_keep(layers[name])
            backbone = {**bp, "layers": layers}
        else:  # hybrid: per-layer dicts; every dense projection
            layers_list = []
            for lp in bp["layers_list"]:
                lp = dict(lp)
                for name in ("in_proj", "out_proj", "wqkv", "wo", "w1", "w2"):
                    if name in lp:
                        lp[name] = q_or_keep(lp[name])
                layers_list.append(lp)
            backbone = {**bp, "layers_list": layers_list}
        self.params = {**self.params, "backbone": backbone,
                       "heads": q_or_keep(self.params["heads"])}
        return self

    def set_storage(self, kv: str | None = None, ssm: str | None = None) -> "Zonos":
        """Cache storage of later ``generate`` calls, the counterpart of
        zonos_tpu/utils/quant_env.py ``set_storage_env``: ``kv`` None (the
        compute dtype), ``"f8"`` or ``"int8"`` for the transformer's KV cache;
        ``ssm`` None (the batch-aware default), ``"fp32"``, ``"bf16"``,
        ``"f8"``, ``"int8"`` or ``"int4"`` for the hybrid's SSM state.  The hybrid's attention layers
        keep their KV cache in the compute dtype whatever ``kv`` says."""
        if kv is not None and kv not in KV_STORAGE:
            raise ValueError(f"KV cache storage {kv!r}: want None|f8|int8")
        if ssm is not None:
            ssm_state_mode(mode=ssm)  # raises on a mode the port does not have
        self.storage = {"kv": kv, "ssm": ssm}
        return self

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
    def _row_keys(self, seed, batch_size: int) -> torch.Tensor:
        """Each row's noise key ``[B]``, from that row's seed alone; a scalar
        seed fans out as ``seed + row``."""
        seeds = np.asarray(seed, np.int64)
        if seeds.ndim == 0:
            seeds = int(seeds) + np.arange(batch_size, dtype=np.int64)
        elif seeds.shape != (batch_size,):
            raise ValueError(f"seed must be a scalar or length-{batch_size} "
                             f"sequence, got shape {seeds.shape}")
        return row_keys(torch.from_numpy(seeds).to(self.device))

    @torch.inference_mode()
    def generate(
        self,
        prefix_conditioning: torch.Tensor,  # [2B, cond_len, d_model]
        audio_prefix_codes: np.ndarray | torch.Tensor | None = None,  # [B, K, P]
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        batch_size: int = 1,
        sampling_params: dict | SamplingParams | None = None,
        seed=423,
        progress_bar: bool = True,
        callback: Callable[[np.ndarray, int, int], bool] | None = None,
        step_limits: np.ndarray | list[int] | int | None = None,
    ) -> list[np.ndarray]:
        """Sample DAC codes; returns a list of per-sample [K, T_i] int arrays
        (EOS-trimmed, the audio prefix cut off).  ``audio_prefix_codes``
        [B, K, P] (``DACAutoencoder.load_prefix_audio``) are prefilled after
        the conditioning and continued.  ``step_limits`` caps new frames per
        sample (or for all); ``seed`` is a scalar or one seed per sample.  On
        the card the decode steps are CUDA-graph replays.

        Every ``SYNC_INTERVAL`` steps, where the host reads ``remaining``
        anyway, and once at the end, ``progress_bar`` rewrites one line on
        stderr and ``callback(frame, done, total)`` is called, as JAX's host
        chunks call it (zonos_tpu/models/tts.py:693-728): ``frame`` is
        ``delayed[..., offset:offset + 1]`` [B, K, 1] at that point, ``done``
        the steps taken as ``max_steps - max(remaining)``, ``total`` the
        step budget.  A callback that returns a false value stops the decode;
        the codes so far are trimmed as a finished run's are."""
        return self._generate(prefix_conditioning, max_new_tokens, cfg_scale, batch_size,
                              sampling_params, seed, step_limits, graphs=self._graphs_on(),
                              audio_prefix_codes=audio_prefix_codes,
                              progress_bar=progress_bar, callback=callback)

    @torch.inference_mode()
    def _generate(self, prefix_conditioning, max_new_tokens, cfg_scale, batch_size,
                  sampling_params, seed, step_limits, graphs: bool,
                  audio_prefix_codes=None, progress_bar: bool = False,
                  callback=None) -> list[np.ndarray]:
        """``generate``; ``graphs`` False runs every decode step eagerly (on
        the card too: what the graphs are held against)."""
        rows = self._data_rows(prefix_conditioning, batch_size, seed, step_limits,
                               audio_prefix_codes)
        with model_axis(self._model_group):
            run = self._prefill(rows.prefix, max_new_tokens, cfg_scale, rows.batch,
                                sampling_params, rows.seed, rows.step_limits,
                                rows.audio_prefix_codes, trace=sampling_trace_on())
            step_graphs = _StepGraphs(self, run) if graphs else None
            bar = _ProgressLine(run.max_steps) if progress_bar else None
            steps = 0
            try:
                for step in range(run.max_steps + 1):
                    # the host's only reads: at a chunk boundary and after the last step
                    if step == run.max_steps or (step and step % SYNC_INTERVAL == 0):
                        if run.trace is not None:
                            _log_trace(run, steps)
                        remaining, go_on = self._poll(run, bar, callback)
                        if not go_on or remaining <= 0 or step == run.max_steps:
                            break
                    self._step(run, step_graphs, step)
                    steps += 1
            finally:
                if bar is not None:
                    bar.close()
        self._record_stats(steps, step_graphs)
        out = self._trim(run.delayed.cpu().numpy(), int(run.offset), rows.step_limits,
                         run.prefix_audio_len)
        return [r for part in gather_objects(out, axis_group(self.mesh, "data")) for r in part]

    def _data_rows(self, prefix_conditioning, batch_size: int, seed, step_limits,
                   audio_prefix_codes, active_rows=None) -> "_Rows":
        """This data rank's part of a call's per-row arguments: its requests
        ``[r B/n, (r+1) B/n)`` with their uncond rows ``B + i``, their seeds
        (a scalar seed fans out as ``seed + row`` over the whole batch first),
        step limits, audio prefixes and active flags; the arguments as they
        are without a data axis."""
        n = axis_size(self.mesh, "data")
        B = batch_size
        if n == 1:
            return _Rows(prefix_conditioning, B, seed, step_limits, audio_prefix_codes,
                         active_rows, 0)
        from zonos_tpu_torch.parallel.sharding import batch_sharding

        rows = batch_sharding(self.mesh, B)
        if prefix_conditioning.shape[0] != 2 * B:
            raise ValueError(f"prefix_conditioning batch {prefix_conditioning.shape[0]} != 2*{B}")
        prefix = torch.cat([prefix_conditioning[rows],
                            prefix_conditioning[B + rows.start:B + rows.stop]])
        seeds = np.asarray(seed, np.int64)
        if seeds.ndim == 0:
            seeds = int(seeds) + np.arange(B, dtype=np.int64)
        elif seeds.shape != (B,):
            raise ValueError(f"seed must be a scalar or length-{B} sequence, got shape "
                             f"{seeds.shape}")

        def cut(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a[rows]
            return np.broadcast_to(np.asarray(a), (B, *np.shape(a)[1:]))[rows]

        return _Rows(prefix, rows.stop - rows.start, seeds[rows], cut(step_limits),
                     cut(audio_prefix_codes), cut(active_rows), rows.start)

    def _poll(self, run: "_DecodeRun", bar: "_ProgressLine | None", callback
              ) -> tuple[int, bool]:
        """A poll of the decode: the steps left (the most over the mesh) and
        whether to go on (every rank's callback says so).  The callback gets
        the whole batch's frame, gathered over the data axis."""
        remaining = int(run.state.remaining.max())
        world = world_of(self.mesh)
        if world is None:
            return remaining, self._report(run, remaining, bar, callback)
        off = int(run.offset)
        got = gather_objects((remaining, run.delayed[..., off:off + 1].cpu().numpy()), world)
        remaining = max(r for r, _ in got)
        frame = np.concatenate([f for _, f in got[::axis_size(self.mesh, "model")]])
        go_on = self._report(run, remaining, bar, callback, frame)
        return remaining, all(gather_objects(go_on, world))

    def stream_generate(
        self,
        prefix_conditioning: torch.Tensor,  # [2, cond_len, d_model] (batch 1)
        audio_prefix_codes: np.ndarray | torch.Tensor | None = None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        sampling_params: dict | SamplingParams | None = None,
        seed=423,
        chunk_frames: int = 43,
        margin_frames: int = 32,
    ):
        """Streaming synthesis at batch 1: yields float32 waveform chunks
        (44.1 kHz, [samples]) while the decode runs.  Each sample is final:
        the concatenation equals the full decode of the same codes, as
        :meth:`stream_generate_batch` says (zonos_tpu/models/tts.py:754-800)."""
        if prefix_conditioning.shape[0] != 2:
            raise ValueError("stream_generate supports batch_size=1 only")
        for events in self.stream_generate_batch(
                prefix_conditioning, audio_prefix_codes=audio_prefix_codes,
                max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
                sampling_params=sampling_params, seed=seed, chunk_frames=chunk_frames,
                margin_frames=margin_frames, batch_size=1):
            for _row, chunk in events:
                yield chunk

    def stream_generate_batch(
        self,
        prefix_conditioning: torch.Tensor,  # [2B, cond_len, d_model]
        audio_prefix_codes: np.ndarray | torch.Tensor | None = None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        sampling_params: dict | SamplingParams | None = None,
        seed=423,
        chunk_frames: int = 43,
        margin_frames: int = 32,
        batch_size: int = 1,
        step_limits=None,
        active_rows=None,
    ):
        """Batched streaming synthesis (zonos_tpu/models/tts.py:802-986): the B
        rows ride one decode; after each chunk of ``chunk_frames`` steps this
        yields a list of ``(row, waveform_chunk)`` events.  A row stops
        yielding at its EOS or its ``step_limits`` cap, as ``generate`` ends
        it.

        Steady chunks are vocoded together from a window with at least
        ``margin_frames`` of real codes on each side of the emitted part,
        which makes them final iff the margin covers the DAC decoder's
        receptive half-width (``autoencoder.receptive_field_frames``; a
        smaller margin raises ``ValueError``).  A row's last chunk is vocoded
        on exactly its own codes, so each row's chunks concatenate to the
        full decode of its codes.  A window's start is pulled down so its
        width is a multiple of 32 frames, as JAX buckets it.  ``active_rows``
        [B] bool: False rows (padding) yield nothing and are not vocoded.
        The decode steps are CUDA-graph replays on the card, as in
        ``generate``; the host reads the codes once a chunk."""
        if prefix_conditioning.shape[0] != 2 * batch_size:
            raise ValueError(f"prefix_conditioning rows ({prefix_conditioning.shape[0]}) "
                             f"!= 2*batch_size ({2 * batch_size})")
        rf = self.autoencoder.receptive_field_frames
        if margin_frames < rf:
            raise ValueError(f"margin_frames={margin_frames} is below the DAC decoder's receptive "
                             f"half-width ({rf} frames): emitted chunks would not be final")
        rows = self._data_rows(prefix_conditioning, batch_size, seed, step_limits,
                               audio_prefix_codes, active_rows)
        world = world_of(self.mesh)
        with torch.inference_mode(), model_axis(self._model_group):
            run = self._prefill(rows.prefix, max_new_tokens, cfg_scale, rows.batch,
                                sampling_params, rows.seed, rows.step_limits,
                                rows.audio_prefix_codes)
        step_graphs = _StepGraphs(self, run) if self._graphs_on() else None
        K, B, P = self.config.num_codebooks, rows.batch, run.prefix_audio_len
        hop = self.autoencoder.hop
        limits = (None if rows.step_limits is None
                  else np.broadcast_to(np.asarray(rows.step_limits, np.int64), (B,)))
        emitted = np.zeros((B,), np.int64)  # frames emitted, after the prefix
        ends = np.full((B,), -1, np.int64)  # a row's final length once known
        row_done = (np.zeros((B,), bool) if rows.active_rows is None
                    else ~np.asarray(rows.active_rows, bool))

        def finalized_codes() -> np.ndarray:
            """[B, K, avail] final codes after the prefix (masked ids zeroed),
            and each row's end once its EOS or its limit is among them."""
            out = revert_delay_pattern(run.delayed.cpu().numpy())[:, :, :int(run.offset) - K]
            is_eos = out[:, 0, P:] == self.eos_token_id
            avail_now = is_eos.shape[1]
            pos = np.zeros((B,), np.int64) if avail_now == 0 else is_eos.argmax(axis=1)
            for i in range(B):
                if ends[i] >= 0:
                    continue
                # a first EOS at frame 0 (or none) means full length: the end stays open
                cand = int(pos[i]) if (is_eos[i].any() and pos[i] > 0) else None
                if limits is not None:
                    lim = int(limits[i])
                    if cand is None or cand > lim:
                        cand = lim if avail_now >= lim else None
                if cand is not None:
                    ends[i] = cand
            out = np.where(out >= self.config.codebook_size, 0, out)
            return out[:, :, P:]

        def decode_rows(codes_w: np.ndarray) -> np.ndarray:
            return self.autoencoder.decode(codes_w)[:, 0]  # [R, samples]

        def bucket_w0(w0: int, hi: int) -> int:
            """Pull the window's start down to a width of a multiple of 32
            frames; more left context only brings it closer to the full decode."""
            width = -(-(hi - w0) // 32) * 32
            return max(0, hi - width)

        step = 0
        done = False
        while not done:
            with torch.inference_mode(), model_axis(self._model_group):
                for _ in range(min(chunk_frames, run.max_steps - step)):
                    self._step(run, step_graphs, step)
                    step += 1
            remaining = int(run.state.remaining.max())
            if world is not None:  # every rank runs the mesh's chunks
                remaining = max(gather_objects(remaining, world))
            done = step >= run.max_steps or remaining <= 0
            codes = finalized_codes()
            avail = codes.shape[2]
            if done:
                for i in range(B):
                    if ends[i] < 0:
                        ends[i] = avail if limits is None else min(avail, limits[i])
            hi_steady = avail if done else avail - margin_frames
            events: list[tuple[int, np.ndarray]] = []
            steady: list[int] = []
            for i in range(B):
                if row_done[i]:
                    continue
                if ends[i] >= 0:
                    # the end is known, so the rest of the row is final: vocode it on the row's
                    # exact codes
                    lo = int(emitted[i])
                    if ends[i] > lo:
                        w0 = bucket_w0(max(0, lo - margin_frames), int(ends[i]))
                        wav = decode_rows(codes[i:i + 1, :, w0:ends[i]])[0]
                        events.append((i, wav[(lo - w0) * hop:(ends[i] - w0) * hop]))
                        emitted[i] = ends[i]
                    row_done[i] = True
                elif hi_steady > emitted[i]:
                    steady.append(i)
            if steady:
                w0 = bucket_w0(max(0, int(min(emitted[i] for i in steady)) - margin_frames),
                               avail)
                wavs = decode_rows(codes[steady, :, w0:avail])
                for j, i in enumerate(steady):
                    lo = int(emitted[i])
                    events.append((i, wavs[j, (lo - w0) * hop:(hi_steady - w0) * hop]))
                    emitted[i] = hi_steady
            self._record_stats(step, step_graphs)
            all_done = bool(row_done.all())
            if world is not None:  # the whole batch's events, by global row
                got = gather_objects(([(rows.start + i, w) for i, w in events], all_done), world)
                events = [e for ev, _ in got[::axis_size(self.mesh, "model")] for e in ev]
                all_done = all(flag for _, flag in got)
            if events:
                yield events
            if all_done:
                break

    @staticmethod
    def _report(run: "_DecodeRun", remaining: int, bar: "_ProgressLine | None",
                callback, frame: np.ndarray | None = None) -> bool:
        """A chunk boundary's progress line and callback (``frame``: the
        batch's current frame, this run's own by default); False stops the
        decode."""
        done = min(run.max_steps, run.max_steps - remaining)
        if bar is not None:
            bar.update(done)
        if callback is None:
            return True
        if frame is None:
            off = int(run.offset)
            frame = run.delayed[..., off:off + 1].cpu().numpy()
        return bool(callback(frame, done, run.max_steps))

    def _step(self, run: "_DecodeRun", step_graphs: "_StepGraphs | None", step: int) -> None:
        """Decode step ``step`` of ``run``: eagerly, or as a graph replay."""
        band = band_of(run.pos0 + step + 1)  # the attended length; the device holds it too
        if step_graphs is None:
            self._decode_step(run, band)
        else:
            step_graphs.step(band)

    def _record_stats(self, steps: int, step_graphs: "_StepGraphs | None") -> None:
        self.decode_stats = {"steps": steps, "graphs": 0, "capture_s": 0.0,
                             "mesh": mesh_shape(self.mesh),
                             "eager": self._eager_reason() if self.device.type == "cuda" else None}
        if step_graphs is not None:
            self.decode_stats.update(graphs=len(step_graphs.graphs),
                                     capture_s=step_graphs.capture_s)

    def _prefill(self, prefix_conditioning, max_new_tokens, cfg_scale, batch_size,
                 sampling_params, seed, step_limits, audio_prefix_codes=None,
                 trace: bool = False) -> "_DecodeRun":
        """Everything before the first decode step: the cache, the prefill over
        the conditioning, the delayed audio prefix and the first column, its
        sampled frame, and the decode loop's state on the device.  ``trace``:
        each sampled step writes its distribution's statistics into a ring of
        SYNC_INTERVAL rows on the device (``generate`` logs them at its
        polls)."""
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

        prefix_audio_len = 0
        if audio_prefix_codes is not None:
            audio_prefix_codes = (audio_prefix_codes.to(torch.int64)
                                  if isinstance(audio_prefix_codes, torch.Tensor)
                                  else torch.as_tensor(np.asarray(audio_prefix_codes),
                                                       dtype=torch.int64))
            if audio_prefix_codes.dim() != 3 or audio_prefix_codes.shape[:2] != (B, K):
                raise ValueError(f"audio_prefix_codes of shape {tuple(audio_prefix_codes.shape)}, "
                                 f"expected [{B}, {K}, P]")
            prefix_audio_len = audio_prefix_codes.shape[2]
        cond_len = prefix.shape[1]
        audio_len = prefix_audio_len + max_new_tokens
        total_seq = find_multiple(cond_len + audio_len + K, 64)
        window = max(sampling.repetition_penalty_window, 1)
        prefill_len = prefix_audio_len + 1
        # one cache row per backbone row: 2B with CFG, B without
        cache = self.backbone.make_cache(cfg.backbone, prefix.shape[0], total_seq,
                                         self.compute_dtype, dev, **self.storage)
        keys = self._row_keys(seed, B)
        counters = element_counters(K * cfg.padded_vocab_size, dev)
        sampled = sampling.temperature > 0

        codes = torch.full((B, K, audio_len), UNKNOWN_TOKEN, dtype=torch.int64, device=dev)
        if prefix_audio_len:
            codes[..., :prefix_audio_len] = audio_prefix_codes.to(dev)
        delayed = apply_delay_pattern(codes, mask_id)  # [B, K, audio_len + K]

        # ---- prefill over the text prefix + the delayed audio prefix -------
        audio_embeds = embed_codes(params, delayed[..., :prefill_len])
        if use_cfg:
            audio_embeds = audio_embeds.repeat(2, 1, 1)
        x = torch.cat([prefix, audio_embeds.to(prefix.dtype)], dim=1)
        hidden, cache = self.backbone.prefill(cfg.backbone, bp, x, cache)
        logits = _compute_step_logits(params, cfg, hidden[:, -1], cfg_scale, use_cfg)
        if sampling.ban_eos:
            logits[:, :, eos_id] = float("-inf")
        noise = None
        if sampled:
            draw = torch.full((1,), PREFILL_DRAW, dtype=torch.int64, device=dev)
            noise = keyed_gumbel(keys, 0, draw, counters, (K, cfg.padded_vocab_size))[0]
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

        # EOS down-weighting bias; with ban_eos codebook 0's EOS is -inf too
        bias = torch.zeros((K, cfg.padded_vocab_size), dtype=torch.float32, device=dev)
        bias[1:, eos_id] = float("-inf")
        bias[0, eos_id] = float("-inf") if sampling.ban_eos else -math.log(1024.0)

        def scalar(value, dtype=torch.float32):
            return torch.full((), value, dtype=dtype, device=dev)

        return _DecodeRun(
            delayed=delayed, cache=cache, state=state, step=scalar(0, torch.int64),
            offset=scalar(prefill_len, torch.int64), keys=keys, counters=counters,
            draws=torch.arange(STEP_DRAWS, dtype=torch.int64, device=dev),
            bias=bias, window_cols=torch.arange(min(window, delayed.shape[2]), device=dev),
            penalty=scalar(sampling.repetition_penalty), one=scalar(1.0),
            pos0=cond_len + prefill_len, prefill_len=prefill_len,
            prefix_audio_len=prefix_audio_len, window=window,
            max_steps=max_steps, cfg_scale=cfg_scale, use_cfg=use_cfg, sampling=sampling,
            trace=(torch.zeros((SYNC_INTERVAL, B, K, 3), dtype=torch.float32, device=dev)
                   if trace and sampled else None))

    def _decode_step(self, run: "_DecodeRun", band: Band) -> None:
        """One decode step on ``run``'s device state, in place; ``band`` holds
        the attended length (the step's position plus one).  Reads nothing
        back to the host, so it is captured as it is into a CUDA graph."""
        cfg = self.config
        K, Vp = cfg.num_codebooks, cfg.padded_vocab_size
        eos_id, mask_id = cfg.eos_token_id, cfg.masked_token_id
        delayed, state, sampling = run.delayed, run.state, run.sampling
        active = state.remaining.max() > 0  # device bool: the while_loop's cond
        off = run.step + (run.prefill_len + 1)  # == offset + 1 while active
        # a step after every row finished may read an unfilled (-1) column;
        # its result is discarded, but the gather must not see -1
        h = embed_codes(self.params, delayed.index_select(2, (off - 1).reshape(1)).clamp_min(0))
        if run.use_cfg:
            h = h.repeat(2, 1, 1)
        pos = StepPosition.of(run.step + run.pos0, band)
        hidden, _ = self.backbone.decode_step(cfg.backbone, self.params["backbone"], h,
                                              run.cache, pos)
        logits = _compute_step_logits(self.params, cfg, hidden[:, -1], run.cfg_scale,
                                      run.use_cfg) + run.bias

        # per-sample repetition penalty, 1.0 in EOS mode
        rp = torch.where(state.eos_mode, run.one, run.penalty)
        logits, masked_state = eos_logit_mask(state, logits, eos_id)
        gen_window = repetition_window(delayed, off, run.window, run.window_cols)
        if run.trace is not None:  # this step's distribution, into its row of the ring
            stats = prob_stats(sampling_probs(logits, sampling, gen_window, rp))
            run.trace.index_copy_(0, (run.step % SYNC_INTERVAL).reshape(1), stats[None])
        noise = (keyed_gumbel(run.keys, run.step, run.draws, run.counters, (K, Vp))
                 if run.sampled else (None, None))
        token = sample_from_logits(logits, sampling, noise[0], gen_window, rp)
        # the first-EOS substitute frame, sampled with EOS banned
        banned = logits.clone()
        banned[:, 0, eos_id] = float("-inf")
        token2 = sample_from_logits(banned, sampling, noise[1], gen_window, rp)
        token, new_state = eos_update(masked_state, token, token2, eos_id, mask_id, K,
                                      MAX_STEPS_AFTER_EOS)

        write_frame(delayed, off, token, active)
        for new, old in zip(new_state, state):
            old.copy_(torch.where(active, new, old))
        run.offset.add_(active.to(run.offset.dtype))
        run.step.add_(1)

    def _trim(self, delayed: np.ndarray, offset: int, step_limits,
              prefix_audio_len: int = 0) -> list[np.ndarray]:
        """Revert the delay, cut at ``offset - K``, then per sample at the first
        codebook-0 EOS and at its step limit, and cut the audio prefix off."""
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
                end = min(end, prefix_audio_len + int(limits[i]))
            results.append(out[i, :, prefix_audio_len:end].copy())
        return results


@dataclass
class _Rows:
    """A data rank's part of a call's per-row arguments (``Zonos._data_rows``)."""

    prefix: torch.Tensor  # [2 * batch, cond_len, d]: its cond rows over their uncond rows
    batch: int
    seed: object
    step_limits: object
    audio_prefix_codes: object
    active_rows: object
    start: int  # its first row in the whole batch


class _ProgressLine:
    """The decode's progress as one line on stderr, rewritten in place: the
    counterpart of JAX's tqdm bar, with no dependency."""

    def __init__(self, total: int):
        self.total, self.t0 = total, time.perf_counter()
        self.update(0)

    def update(self, done: int) -> None:
        rate = done / max(time.perf_counter() - self.t0, 1e-9)
        sys.stderr.write(f"\rGenerating: {done}/{self.total} steps, {rate:.1f} steps/s")
        sys.stderr.flush()

    def close(self) -> None:
        sys.stderr.write("\n")
        sys.stderr.flush()


@dataclass
class _DecodeRun:
    """The decode loop's state: tensors on the model's device, read and
    written in place by each step (so that a captured step replays on the
    same buffers), and the host constants of one ``generate`` call."""

    delayed: torch.Tensor  # [B, K, T] int64, the delayed codes filled so far
    cache: object  # the backbone's cache
    state: EosState
    step: torch.Tensor  # int64 0-d: decode steps taken
    offset: torch.Tensor  # int64 0-d: the while_loop's offset
    keys: torch.Tensor  # [B] int64: each row's noise key
    counters: torch.Tensor  # [K * V_pad] int64: the noise's mixed element counters
    draws: torch.Tensor  # [2] int64: the token's draw and the EOS-banned substitute's
    bias: torch.Tensor  # [K, V_pad] fp32 EOS bias
    window_cols: torch.Tensor  # [W] int64: the repetition window's columns from its start
    penalty: torch.Tensor  # fp32 0-d: the repetition penalty
    one: torch.Tensor  # fp32 0-d 1.0: the penalty in EOS mode
    pos0: int  # cache row of the first decode step
    prefill_len: int  # the audio prefix's frames and the first column
    prefix_audio_len: int
    window: int
    max_steps: int
    cfg_scale: float
    use_cfg: bool
    sampling: SamplingParams
    # [SYNC_INTERVAL, B, K, 3] fp32: the sampling trace's ring (step % SYNC_INTERVAL), or None
    trace: torch.Tensor | None = None
    logged: int = 0  # steps whose trace line is written

    @property
    def sampled(self) -> bool:
        return self.sampling.temperature > 0


def _log_trace(run: _DecodeRun, steps: int) -> None:
    """One trace line for each step taken since the last poll, read from the
    ring (at most SYNC_INTERVAL steps: the loop polls that often)."""
    ring = run.trace.cpu().numpy()
    for t in range(run.logged, steps):
        log_prob_stats(ring[t % SYNC_INTERVAL])
    run.logged = steps


class _StepGraphs:
    """The decode step on the card as CUDA graphs: the first step runs
    eagerly on a side stream (every kernel library loaded, every kernel
    attribute set, so that nothing of that happens during a capture); then
    each band of lengths is captured once, when the loop first reaches it,
    and replayed at every step in it.  A graph's kernel launches are counted
    at capture and added to ``launch_counts`` at each replay.  A failed
    capture or replay raises; nothing falls back to the eager step."""

    def __init__(self, model: Zonos, run: _DecodeRun):
        self.model, self.run = model, run
        self.graphs: dict[Band, tuple[torch.cuda.CUDAGraph, dict[str, int]]] = {}
        self.capture_s = 0.0
        self.warm = False

    def step(self, band: Band) -> None:
        dev = self.model.device
        if not self.warm:
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.model._decode_step(self.run, band)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.warm = True
            return
        entry = self.graphs.get(band)
        if entry is None:
            # the capture waits for the card anyway; wait first, so that the capture time
            # holds none of the work queued before it
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            before = dict(launch_counts)
            with torch.cuda.graph(graph):
                self.model._decode_step(self.run, band)
            entry = self.graphs[band] = (graph, launches_since(before))
            launch_counts.update(before)  # capturing launched nothing
            self.capture_s += time.perf_counter() - t
        graph, launches = entry
        graph.replay()
        add_launches(launches)
