"""The port's continuous batcher (``zonos_tpu_torch.serving.batching``) on the
CPU: against the JAX package's where the two compute the same thing, and
alone for the scheduler's host logic.

Against JAX, on the same fp32 weights (JAX init through
``zonos_tpu_torch.convert``): ``build_batch_prefix`` within 1e-5 (per-row
uncond, padding to the multiple, a missing required key raising), and the
greedy codes of three co-batched ``codes_only`` requests identical.

Port only (a bf16 random model and a small DAC with the full hop of 512
samples): merging, a bad request failing alone, grouping by key, mixed
durations, CFG-free requests, admission 503, a burst that sheds, deadlines
in the queue and mid-stream, stream cancel, interleaved streams, warmup's
count, instant-EOS rows, and the contract that a sampled request's whole
audio is bit-identical solo and co-batched.
"""

from __future__ import annotations

import copy
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401
from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from zonos_tpu.serving import TTSRequest as JaxTTSRequest
from zonos_tpu.serving import build_batch_prefix as jax_build_batch_prefix
from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params
from zonos_tpu_torch.models.dac.codec import DACConfig
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.serving import ContinuousBatcher, StreamRequest, TTSRequest, build_batch_prefix
from zonos_tpu_torch.serving.batching import ServerOverloaded

SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
UNCOND_PITCH = frozenset({"emotion", "vqscore_8", "dnsmos_ovrl", "pitch_std"})
GREEDY = SamplingParams.greedy()


def _tiny_dict() -> dict:
    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return d


def _spk(seed):
    return np.random.default_rng(seed).normal(size=(1, 1, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the same fp32 weights."""
    jm = JaxZonos(JaxZonosConfig.from_dict(_tiny_dict()), seed=0)
    jm.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    tm = Zonos(ZonosConfig.from_dict(_tiny_dict()),
               params=convert_zonos_params(jax.tree.map(np.asarray, jm.params)), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    """A bf16 port model (random, seed 0) with a small codec."""
    m = Zonos(ZonosConfig.from_dict(_tiny_dict()), seed=0, device="cpu")
    m._autoencoder = DACAutoencoder(cfg=DACConfig(**SMALL_DAC), device="cpu")
    return m


def _batcher(model, **kw):
    args = dict(max_batch=4, max_wait_ms=500.0, cond_pad_multiple=16, batch_buckets=(1, 2, 4))
    args.update(kw)
    return ContinuousBatcher(model, **args)


def _req(text, seed=0, **kw):
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("max_new_tokens", 18)
    return TTSRequest(cond_dict=make_cond_dict(text=text, speaker=_spk(seed)), **kw)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


PREFIX_CASES = {
    "two-rows": (dict(text="Hello there", pitch_std=30.0), dict(text="Hello there", pitch_std=90.0),
                 1),
    "per-row-uncond": (dict(text="Mixed rows", pitch_std=55.0),
                       dict(text="Mixed rows", unconditional_keys=UNCOND_PITCH), 1),
    "pads-to-32": (dict(text="Pad me"), dict(text="A somewhat longer text to pad"), 32),
}


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_build_batch_prefix_matches_jax(pair, case):
    jm, tm = pair
    a, b, multiple = PREFIX_CASES[case]
    dicts = [dict(a, speaker=_spk(0)), dict(b, speaker=_spk(1))]
    ref = np.asarray(jax_build_batch_prefix(jm, [jax_make_cond_dict(**d) for d in dicts],
                                            pad_multiple=multiple), np.float32)
    ours = build_batch_prefix(tm, [make_cond_dict(**d) for d in dicts], pad_multiple=multiple)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    n_other = len(tm.specs) - 1  # one slot per non-phoneme conditioner
    assert (ours.shape[1] - n_other) % multiple == 0


@pytest.mark.parametrize("model", ["fp32", "bf16"])
def test_build_batch_prefix_rows_equal_prepare_conditioning(pair, tiny, model):
    """Each request's rows of the merged prefix are ``prepare_conditioning``
    of it alone at the same padding, bit for bit: they are computed on their
    own, never as rows of a larger product."""
    m = pair[1] if model == "fp32" else tiny
    dicts = [dict(text="Mixed rows", speaker=_spk(0), pitch_std=55.0),
             dict(text="Other rows here", speaker=_spk(1), unconditional_keys=UNCOND_PITCH),
             dict(text="Third", speaker=_spk(2), emotion=[0.5] + [0.1] * 7)]
    merged = build_batch_prefix(m, [make_cond_dict(**d) for d in dicts], pad_multiple=32)
    B = len(dicts)
    for i, d in enumerate(dicts):
        alone = m.prepare_conditioning(make_cond_dict(**d), pad_to_multiple=32)
        assert torch.equal(merged[i], alone[0]) and torch.equal(merged[B + i], alone[1])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_build_batch_prefix_missing_required_raises(package):
    """With the speaker conditioner made required (no learned uncond vector),
    a request without a speaker raises in both packages, the port's message
    naming the key."""
    d = _tiny_dict()
    d["prefix_conditioner"]["conditioners"][1] = {
        "type": "PassthroughConditioner", "name": "speaker", "cond_dim": 128,
        "uncond_type": "none", "projection": "linear"}
    if package == "jax":
        model, cond, build = JaxZonos(JaxZonosConfig.from_dict(d), seed=0), jax_make_cond_dict, \
            jax_build_batch_prefix
    else:
        model, cond, build = Zonos(ZonosConfig.from_dict(d), seed=0, device="cpu"), \
            make_cond_dict, build_batch_prefix
    good = cond(text="x", speaker=_spk(0))
    missing = cond(text="x", speaker=None)
    assert missing["speaker"] is None
    assert build(model, [good]).shape[0] == 2
    with pytest.raises(ValueError, match="required conditioning key: speaker"):
        build(model, [good, missing])


def test_batcher_greedy_codes_match_jax(pair):
    """Three co-batched codes_only requests through each package's batcher
    give identical greedy codes."""
    jm, tm = pair
    texts = ["request number one", "request number two", "request number six"]
    limits = [18, 12, 24]
    outs = {}
    for name, batcher_cls, req_cls, cond, sampling in (
            ("jax", JaxContinuousBatcher, JaxTTSRequest, jax_make_cond_dict,
             JaxSamplingParams.greedy()),
            ("port", ContinuousBatcher, TTSRequest, make_cond_dict, GREEDY)):
        b = batcher_cls(jm if name == "jax" else tm, max_batch=4, max_wait_ms=1000.0,
                        batch_buckets=(1, 2, 4))
        try:
            pend = [b.submit(req_cls(cond_dict=cond(text=t, speaker=_spk(i)), sampling=sampling,
                                     max_new_tokens=n, codes_only=True))
                    for i, (t, n) in enumerate(zip(texts, limits))]
            outs[name] = [np.asarray(p.wait(timeout=600)) for p in pend]
            assert b.snapshot()["max_batch_seen"] == 3, b.snapshot()
        finally:
            b.close()
    for a, ref, n in zip(outs["port"], outs["jax"], limits):
        assert a.shape == ref.shape and a.shape[0] == 9 and 1 <= a.shape[1] <= n
        np.testing.assert_array_equal(a, ref)


# ---------------------------------------------------------------------------
# host logic (port only)
# ---------------------------------------------------------------------------


def test_batcher_merges_requests(tiny):
    b = _batcher(tiny)
    try:
        pend = [b.submit(_req(f"request number {i}", i)) for i in range(4)]
        for p in pend:
            w = p.wait(timeout=300)
            assert w.ndim == 2 and w.shape[-1] > 0 and np.isfinite(w).all()
        s = b.snapshot()
        assert s["completed"] == 4 and s["max_batch_seen"] >= 2 and s["batches"] < 4, s
        assert s["capture_seconds"] == 0.0  # no CUDA graphs on the CPU
    finally:
        b.close()


def test_bad_request_does_not_poison_batch(tiny):
    b = _batcher(tiny)
    try:
        good = b.submit(_req("fine request"))
        bad_cd = make_cond_dict(text="broken", speaker=_spk(1))
        bad_cd["espeak"] = (["two", "texts"], ["en-us", "en-us"])
        bad = b.submit(TTSRequest(cond_dict=bad_cd, sampling=GREEDY, max_new_tokens=18))
        assert good.wait(timeout=300).shape[-1] > 0
        with pytest.raises(ValueError, match="one text per request"):
            bad.wait(timeout=300)
        s = b.snapshot()
        assert s["completed"] == 1 and s["failed"] == 1, s
    finally:
        b.close()


def test_batcher_groups_by_key(tiny):
    b = _batcher(tiny, max_wait_ms=300.0)
    try:
        p1 = b.submit(_req("greedy one", 0))
        p2 = b.submit(_req("sampled one", 1, sampling=SamplingParams(min_p=0.1)))
        p1.wait(timeout=300)
        p2.wait(timeout=300)
        s = b.snapshot()
        assert s["batches"] == 2 and s["max_batch_seen"] == 1, s
    finally:
        b.close()


def test_mixed_durations_share_a_batch(tiny):
    b = _batcher(tiny, max_batch=2, batch_buckets=(1, 2))
    try:
        p1 = b.submit(_req("short request", 0, max_new_tokens=10))
        p2 = b.submit(_req("longer request", 1, max_new_tokens=30))
        assert p1.wait(timeout=300).shape[-1] > 0 and p2.wait(timeout=300).shape[-1] > 0
        s = b.snapshot()
        assert s["batches"] == 1 and s["max_batch_seen"] == 2, s
    finally:
        b.close()


def test_cfg_free_requests_through_batcher(tiny):
    b = _batcher(tiny, max_wait_ms=300.0)
    try:
        assert b.warmup(cond_lens=(32,), max_new_tokens=64, sampling=GREEDY,
                        use_cfg=False) == 3
        p1 = b.submit(_req("no guidance", 0, cfg_scale=1.0))
        p2 = b.submit(_req("with guidance", 1, cfg_scale=2.0))
        assert p1.wait(timeout=300).shape[-1] > 0 and p2.wait(timeout=300).shape[-1] > 0
        assert b.snapshot()["batches"] == 2
    finally:
        b.close()


def test_admission_rejects_when_full(tiny):
    b = _batcher(tiny, max_wait_ms=5.0, max_queue=3)
    try:
        admitted = [b.submit(_req("Shed me", max_new_tokens=12)) for _ in range(3)]
        t0 = time.monotonic()
        with pytest.raises(ServerOverloaded) as exc:
            b.submit(_req("Shed me", max_new_tokens=12))
        assert time.monotonic() - t0 < 0.5
        assert exc.value.retry_after >= 1.0
        for p in admitted:
            p.wait(timeout=300)
        assert b.snapshot()["rejected"] == 1
        b.submit(_req("Shed me", max_new_tokens=12)).wait(timeout=300)  # admission reopened
    finally:
        b.close()


def test_burst_sheds_fast_no_stuck_clients(tiny):
    """Twelve clients (more threads than cores, a short switch interval)
    against max_queue=4: the sheds are immediate, every admitted request
    completes, and the in-flight count returns to 0 (a lost update of it
    would leave it off)."""
    b = _batcher(tiny, max_wait_ms=10.0, max_queue=4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outcomes = [None] * 12

        def client(i):
            t0 = time.monotonic()
            try:
                b.submit(_req("Burst", max_new_tokens=12)).wait(timeout=300)
                outcomes[i] = ("ok", time.monotonic() - t0)
            except ServerOverloaded:
                outcomes[i] = ("shed", time.monotonic() - t0)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        kinds = [o[0] for o in outcomes]
        assert kinds.count("shed") >= 1 and kinds.count("ok") >= 4
        assert all(o[1] < 0.5 for o in outcomes if o[0] == "shed")
        snap = b.snapshot()
        assert snap["completed"] == kinds.count("ok") and snap["rejected"] == kinds.count("shed")
        assert snap["inflight"] == 0 and snap["requests"] == kinds.count("ok")
    finally:
        sys.setswitchinterval(interval)
        b.close()


def test_deadline_expired_in_queue(tiny):
    b = _batcher(tiny, max_batch=2, max_wait_ms=5.0, batch_buckets=(1, 2), max_queue=8)
    try:
        slow = b.submit(_req("Too late", max_new_tokens=24))
        doomed = b.submit(_req("Too late", max_new_tokens=12, deadline_s=0.0))
        with pytest.raises(TimeoutError):
            doomed.wait(timeout=300)
        slow.wait(timeout=300)
        assert b.snapshot()["expired"] >= 1
    finally:
        b.close()


def _stream(text, seed=0, **kw):
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("chunk_frames", 8)
    kw.setdefault("margin_frames", 12)
    return StreamRequest(cond_dict=make_cond_dict(text=text, speaker=_spk(seed)), **kw)


def test_stream_deadline_cancels_mid_flight(tiny):
    b = _batcher(tiny, max_batch=2, max_wait_ms=5.0, batch_buckets=(1, 2))
    try:
        h = b.submit_stream(_stream("deadline mid stream", max_new_tokens=1024, deadline_s=2.0))
        got, err = 0, None
        try:
            for _ in h.chunks(timeout=300):
                got += 1
        except TimeoutError as e:
            err = e
        assert err is not None, f"stream finished {got} chunks without its deadline"
        assert h.cancelled
    finally:
        b.close()


def test_stream_cancel_frees_batcher(tiny):
    b = _batcher(tiny, max_wait_ms=50.0)
    try:
        h = b.submit_stream(_stream("cancel me midway", max_new_tokens=64))
        it = h.chunks(timeout=300)
        assert next(it).shape[-1] > 0
        h.cancel()
        for _ in it:  # drains to the end marker without hanging
            pass
        w = b.synthesize(_req("after the cancel", 1), timeout=300)
        assert w.ndim == 2 and w.shape[-1] > 0
    finally:
        b.close()


def test_concurrent_streams_share_batch_and_interleave(tiny):
    b = _batcher(tiny)
    try:
        handles = [b.submit_stream(_stream(f"stream number {i}", i, max_new_tokens=36))
                   for i in range(2)]
        arrivals: dict[int, list[tuple[float, int]]] = {0: [], 1: []}

        def drain(i):
            for chunk in handles[i].chunks(timeout=300):
                arrivals[i].append((time.monotonic(), len(chunk)))

        threads = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(arrivals[i] for i in range(2))
        assert all(n > 0 for a in arrivals.values() for _, n in a)
        first = {i: arrivals[i][0][0] for i in range(2)}
        last = {i: arrivals[i][-1][0] for i in range(2)}
        assert first[0] < last[1] and first[1] < last[0]
        s = b.snapshot()
        assert s["streams"] == 2 and s["batches"] == 1 and "ttfa_p50_s" in s, s
    finally:
        b.close()


def test_late_stream_interleaves_chunkwise(tiny):
    b = _batcher(tiny, max_wait_ms=50.0)
    try:
        h_long = b.submit_stream(_stream("a long running stream", max_new_tokens=256))
        long_times: list[float] = []

        def drain_long():
            for _ in h_long.chunks(timeout=300):
                long_times.append(time.monotonic())

        t = threading.Thread(target=drain_long)
        t.start()
        while not long_times:
            time.sleep(0.02)
        h_late = b.submit_stream(_stream("late arrival", 1, max_new_tokens=16))
        late_first = next(iter(h_late.chunks(timeout=300)))
        t_late = time.monotonic()
        for _ in h_late.chunks(timeout=300):
            pass
        t.join(timeout=300)
        assert late_first.shape[-1] > 0 and t_late < long_times[-1], \
            "the late stream's first chunk came only after the earlier stream ended"
        s = b.snapshot()
        assert s["streams"] == 2 and s["batches"] == 2, s
    finally:
        b.close()


def test_warmup_counts(tiny):
    """warmup runs one single-step generate per batch bucket, cond length and
    prefix length; warmup_streaming adds one decode per window width and
    row count."""
    from zonos_tpu_torch.serving.batching import _startup_widths

    b = _batcher(tiny, max_batch=2, max_wait_ms=10.0, batch_buckets=(1, 2))
    try:
        assert b.warmup(cond_lens=(32,), max_new_tokens=64) == 2
        assert b.warmup(cond_lens=(32,), max_new_tokens=(64, 512),
                        prefix_audio_lens=(0, 8)) == 4
        steady = -(-(8 + 2 * 12) // 32) * 32
        widths = set(range(32, steady + 32, 32)) | _startup_widths(8, 12, 9)
        n = b.warmup_streaming(cond_lens=(16,), max_new_tokens=32, chunk_frames=8,
                               margin_frames=12)
        assert n == 2 + len(widths) * (1 + 2)  # bucket 1: one row count; bucket 2: two
        assert b.snapshot()["requests"] == 0  # warmup is not traffic
    finally:
        b.close()


def test_instant_eos_rows_get_a_zero_hop(tiny):
    """A row with no codes is never DAC-decoded: a [1, 512] zero wav (or empty
    codes for codes_only); its peer is unaffected."""
    b = _batcher(tiny, max_wait_ms=300.0)
    try:
        empty = b.submit(_req("no frames at all", 0, max_new_tokens=0))
        raw = b.submit(_req("no frames at once", 1, max_new_tokens=0, raw_decode=True))
        codes = b.submit(_req("no frames either", 2, max_new_tokens=0, codes_only=True))
        peer = b.submit(_req("some frames here", 3))
        for p in (empty, raw):
            w = p.wait(timeout=300)
            assert w.shape == (1, 512) and not w.any()
        assert codes.wait(timeout=300).shape == (9, 0)
        assert peer.wait(timeout=300).shape[-1] > 512
    finally:
        b.close()


def test_zero_length_prefix_counts_as_none(tiny):
    """A [K, 0] audio prefix co-batches with prefix-free requests and runs as
    none, in either order."""
    b = _batcher(tiny, max_wait_ms=500.0)
    try:
        empty = np.zeros((9, 0), np.int64)
        pend = [b.submit(_req("prefix free one", 0, audio_prefix_codes=empty, codes_only=True)),
                b.submit(_req("prefix free two", 1, codes_only=True)),
                b.submit(_req("prefix free six", 2, audio_prefix_codes=empty, codes_only=True))]
        outs = [p.wait(timeout=300) for p in pend]
        assert all(o.shape[0] == 9 and o.shape[1] > 0 for o in outs)
        s = b.snapshot()
        assert s["failed"] == 0 and s["max_batch_seen"] == 3, s
    finally:
        b.close()


def test_request_audio_independent_of_cobatched_peers(tiny):
    """The same sampled request (text, conditioning, seed) gives bit-identical
    audio, over its whole length, alone and co-batched with peers of its
    cond bucket; and a peer in a longer bucket does not change it either."""

    def req(seed=1234):
        return TTSRequest(cond_dict=make_cond_dict(text="identical either way", speaker=_spk(3)),
                          sampling=SamplingParams(), seed=seed, max_new_tokens=60)

    b = _batcher(tiny, max_wait_ms=10.0)
    try:
        solo = b.submit(req()).wait(timeout=300)
    finally:
        b.close()
    assert solo.shape[-1] > 20 * 512

    b = _batcher(tiny, max_wait_ms=1000.0)
    try:
        peers = [TTSRequest(cond_dict=make_cond_dict(text=t, speaker=_spk(i)),
                            sampling=SamplingParams(), seed=777 + i, max_new_tokens=60)
                 for i, t in enumerate(["a different peer sentence", "another peer utterance yes",
                                        "a third peer sentence here"])]
        pend = [b.submit(req())] + [b.submit(p) for p in peers]
        outs = [p.wait(timeout=300) for p in pend]
        assert b.snapshot()["max_batch_seen"] == 4, b.snapshot()
    finally:
        b.close()
    np.testing.assert_array_equal(solo, outs[0])
    assert not all(np.array_equal(solo, o) for o in outs[1:])

    b = _batcher(tiny, max_wait_ms=1000.0)
    try:
        long_peer = TTSRequest(
            cond_dict=make_cond_dict(text="this peer has a very much longer text that certainly "
                                          "lands in a larger conditioning pad bucket than ours",
                                     speaker=_spk(7)),
            sampling=SamplingParams(), seed=888, max_new_tokens=60)
        pend = [b.submit(req()), b.submit(long_peer)]
        outs2 = [p.wait(timeout=300) for p in pend]
    finally:
        b.close()
    np.testing.assert_array_equal(solo, outs2[0])
