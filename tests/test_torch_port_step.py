"""The one-program decode step of the port, on the CPU.

A decode step reads and writes only tensors on the model's device: the KV
row write, the RoPE rows, the attention length, the input column, the
repetition window and the column written are gathered at a position held on
the device, and the Gumbel noise is keyed by (row seed, step, draw).  So the
step never reads a value back to the host, which is what lets the card
capture it once into a CUDA graph and replay it.  Here:

- a dispatch mode that raises on ``aten._local_scalar_dense`` (``.item()``,
  ``int()``, ``bool()`` of a tensor) wraps every decode step of a
  transformer's and a hybrid's ``generate`` (the prefill and the poll of
  ``remaining`` every 32 steps stay outside it);
- each device-indexed gather and write equals the host slice it replaced bit
  for bit, at the positions where the bands and the buffers end;
- the keyed noise: deterministic, a row's noise its own seed's alone, finite,
  and standard Gumbel over 10^6 draws (mean within 0.01 of Euler's constant,
  variance within 1% of pi^2 / 6);
- the K1/K2 wrappers check the band on the host and clamp a length on the
  device to it, so that no length reads past the cache.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.kernels.decode_attention import (
    Band,
    band_of,
    decode_attention_plain,
    decode_attention_single,
    decode_attention_single_held_out,
    decode_attention_split_plain,
    flash_decode_attention,
    flash_decode_attention_held_out,
)
from zonos_tpu_torch.models import tts
from zonos_tpu_torch.models.backbone import KVCache, rope_at
from zonos_tpu_torch.ops.attention import StepPosition
from zonos_tpu_torch.ops.rope import cached_rope_table
from zonos_tpu_torch.ops.sampling import element_counters, keyed_bits, keyed_gumbel, row_keys

TINY_TRANSFORMER = {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                    "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
TINY_HYBRID = {"d_model": 64, "n_layer": 3, "attn_layer_idx": [1], "attn_mlp_d_intermediate": 128,
               "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16,
                           "d_conv": 4, "ngroups": 1},
               "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                            "rotary_emb_dim": 8}}
# the positions where a band or a buffer ends: 256/257 cross from K2's band to K1's
POSITIONS = (0, 1, 255, 256, 257)
S_MAX = 320


def _model(kind: str) -> Zonos:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT if kind == "transformer" else HYBRID_CONFIG_DICT)
    d["backbone"].update(copy.deepcopy(TINY_TRANSFORMER if kind == "transformer"
                                       else TINY_HYBRID))
    return Zonos(ZonosConfig.from_dict(d), seed=0, device="cpu", dtype=torch.float32)


# the ops through which the host reads a tensor's value: _local_scalar_dense under
# ``.item()``, ``int()`` and ``bool()`` (which reach the mode as ``item`` and
# ``is_nonzero`` under inference mode), and ``equal``
HOST_READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default,
              torch.ops.aten.is_nonzero.default, torch.ops.aten.equal.default}


class NoHostRead(TorchDispatchMode):
    """Raises on any read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"a decode step read a tensor back to the host ({func})")
        return func(*args, **(kwargs or {}))


def test_no_host_read_catches_host_reads():
    x = torch.tensor(3)
    for read in (lambda: int(x), lambda: x.item(), lambda: bool(x > 1),
                 lambda: torch.arange(5)[x]):
        with torch.inference_mode(), pytest.raises(AssertionError), NoHostRead():
            read()


@pytest.mark.parametrize("kind, kv, sampling", [
    ("transformer", None, None),  # the default sampling: keyed noise, K3's plain version
    ("transformer", "int8", {"temperature": 0.0, "repetition_penalty": 1.0}),  # held-out rows
    ("hybrid", None, None),
])
def test_decode_steps_read_nothing_back(kind, kv, sampling, monkeypatch):
    model = _model(kind).set_storage(kv=kv)
    prefix = model.prepare_conditioning(make_cond_dict(text=["Hi there.", "Good day."]))
    step = tts.Zonos._decode_step
    steps = []

    def guarded(self, run, band):
        with NoHostRead():
            step(self, run, band)
        steps.append(band)

    monkeypatch.setattr(tts.Zonos, "_decode_step", guarded)
    codes = model.generate(prefix, max_new_tokens=30, batch_size=2, sampling_params=sampling,
                           seed=[3, 4])
    assert len(steps) > tts.SYNC_INTERVAL  # the poll at step 32 ran between two guarded steps
    assert model.decode_stats["steps"] == len(steps)
    assert len(codes) == 2 and all(c.shape[0] == 9 for c in codes)


# ---------------------------------------------------------------------------
# device gathers and writes against the host slices they replaced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", [None, "f8", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_write_at_device_pos_equals_host_slice(kv, dtype):
    cfg = _model("transformer").config.backbone
    rng = np.random.default_rng(1)
    for pos in POSITIONS + (S_MAX - 1,):
        host, dev = (KVCache.create(cfg, 2, S_MAX, dtype, kv=kv) for _ in range(2))
        for li in range(cfg.n_layer):
            k, v = (torch.from_numpy(rng.normal(size=(2, 1, cfg.num_heads_kv, cfg.head_dim))
                                     .astype(np.float32) * 200).to(dtype) for _ in range(2))
            host.write(li, pos, k, v)
            dev.write(li, StepPosition.at(pos, "cpu"), k, v)
        for a, b in ((host.k, dev.k), (host.v, dev.v), (host.k_scale, dev.k_scale),
                     (host.v_scale, dev.v_scale)):
            if a is not None:
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), pos


def test_rope_gather_equals_host_slice():
    for dim in (64, 8):  # the transformer's head_dim 16 table and the hybrid's rotary part
        cos_t, sin_t = cached_rope_table(dim, 10000.0, torch.device("cpu"))
        for pos in POSITIONS + (S_MAX - 1,):
            got = rope_at(cos_t, sin_t, StepPosition.at(pos, "cpu"), 1)
            want = rope_at(cos_t, sin_t, pos, 1)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), pos


@pytest.mark.parametrize("window", [1, 2, 5])
def test_window_and_frame_gathers_equal_host_slices(window):
    """The repetition window (clamped at column 0), the input column and the
    column written (clamped at the last) at every offset of a short buffer
    and at the band edges of a long one."""
    rng = np.random.default_rng(window)
    for T, offsets in ((12, range(1, 13)), (S_MAX, POSITIONS[1:] + (S_MAX - 1, S_MAX))):
        delayed = torch.from_numpy(rng.integers(-1, 1026, size=(2, 9, T)))
        token = torch.from_numpy(rng.integers(0, 1025, size=(2, 9)))
        cols = torch.arange(min(window, T))
        for off in offsets:
            off_t = torch.tensor(off)
            start = max(off - window, 0)
            assert torch.equal(tts.repetition_window(delayed, off_t, window, cols),
                               delayed[..., start:start + window])
            assert torch.equal(delayed.index_select(2, (off_t - 1).reshape(1)),
                               delayed[..., off - 1:off])
            for active in (True, False):
                want = delayed.clone()
                col = min(off, T - 1)
                frame = want[..., col]
                merged = torch.where(frame == tts.UNKNOWN_TOKEN, token, frame)
                want[..., col] = torch.where(torch.tensor(active), merged, frame)
                got = delayed.clone()
                tts.write_frame(got, off_t, token, torch.tensor(active))
                assert torch.equal(got, want), (T, off, active)


# ---------------------------------------------------------------------------
# keyed noise
# ---------------------------------------------------------------------------

K, VP = 9, 1152


def test_keyed_noise_is_deterministic_and_keyed_apart():
    keys = row_keys(torch.tensor([423, 424, 2**40 + 423]))
    counters = element_counters(K * VP, "cpu")
    draws = torch.arange(3)
    a = keyed_bits(keys, torch.tensor(7), draws, counters)
    assert torch.equal(a, keyed_bits(keys, torch.tensor(7), draws, counters))
    assert torch.equal(a, keyed_bits(keys, 7, draws, counters))  # a host step: the same bits
    assert a.min() >= 0 and a.max() < 2**32
    b = keyed_bits(keys, torch.tensor(8), draws, counters)
    # every (row, step, draw) stream differs from every other in almost every element
    flat = torch.cat([a.reshape(-1, K * VP), b.reshape(-1, K * VP)])
    for i in range(flat.shape[0]):
        for j in range(i):
            assert (flat[i] == flat[j]).float().mean() < 1e-3


def test_keyed_noise_of_a_row_depends_on_its_seed_alone():
    seeds = torch.tensor([5, 6, 7, 8])
    counters = element_counters(K * VP, "cpu")
    step, draws = torch.tensor(3), torch.arange(2)
    batch = keyed_gumbel(row_keys(seeds), step, draws, counters, (K, VP))
    for i in range(4):
        alone = keyed_gumbel(row_keys(seeds[i:i + 1]), step, draws, counters, (K, VP))
        assert torch.equal(alone[:, 0], batch[:, i])


def test_keyed_noise_is_standard_gumbel():
    counters = element_counters(K * VP, "cpu")
    g = keyed_gumbel(row_keys(torch.arange(49)), torch.tensor(11), torch.arange(2), counters,
                     (K, VP)).double()
    assert g.numel() > 10**6 and torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    assert abs(float(g.var()) / (math.pi**2 / 6) - 1) < 0.01


# ---------------------------------------------------------------------------
# the band check of K1/K2's wrappers
# ---------------------------------------------------------------------------


def test_length_outside_the_band_raises_and_reads_nothing_past_the_cache():
    rng = np.random.default_rng(2)
    S = 300
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 1, 8, 128), (2, 4, S, 128), (2, 4, S, 128)))
    new = torch.from_numpy(rng.normal(size=(2, 1, 4, 128)).astype(np.float32))
    # a host length outside the band it is given
    with pytest.raises(ValueError):
        decode_attention_single(q, k, v, 300, band=band_of(100))
    with pytest.raises(ValueError):
        flash_decode_attention_held_out(q, k, v, new, new, 256, band=band_of(256))
    # a band past the cache's end
    with pytest.raises(ValueError):
        flash_decode_attention(q, k, v, torch.tensor(520, dtype=torch.int32),
                               band=Band(513, None))
    # a length on the device past the band (and the cache) is clamped to it, as the
    # kernels clamp it: the rows read stop at the cache's end
    got = flash_decode_attention(q, k, v, torch.tensor(S + 50, dtype=torch.int32),
                                 band=band_of(257))
    assert torch.equal(got, decode_attention_plain(q, k, v, S))
    got = decode_attention_single_held_out(q, k, v, new, new,
                                           torch.tensor(400, dtype=torch.int32),
                                           band=band_of(1))
    assert torch.equal(got, decode_attention_split_plain(q, k, v, new, new, 255))
