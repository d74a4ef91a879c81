"""Continuous batching for TTS serving (the port of zonos_tpu/serving/batching.py).

- **Requests are merged into device batches** by a scheduler thread: the
  first request opens a batch window (``max_wait_ms``); whatever compatible
  requests arrive inside it ride along, up to ``max_batch``.
- **Every axis snaps to a bucket**, as in the JAX package: phoneme prefixes
  are left-padded (PAD, the reference's own intra-batch padding,
  zonos/conditioning.py:186-191) to a multiple of ``cond_pad_multiple``, the
  batch is padded up to the next size in ``batch_buckets`` by repeating the
  last row (surplus outputs dropped on the host), and the step budget to
  :func:`program_frames_bucket`.  The port compiles nothing per shape (its
  kernels are built once; each ``generate`` captures its own CUDA graphs),
  but the buckets fix a request's prefix padding and step budget, and with
  them its codes: the server's long-form path equals the offline one only
  because both bucket alike.
- **Heterogeneous conditioning in one batch**: each request keeps its own
  speaker embedding / emotion / rates; a request that leaves a conditioner
  unconditional gets the learned uncond vector substituted *for its row
  only*.

Requests with different sampling params, cfg_scale, stream cadence or audio
prefix length are grouped apart (:class:`BatchKey`), and so are requests of
different padded conditioning lengths.

**Co-batched rows.**  Each row's noise is keyed by its own request seed,
each request's conditioning rows are computed on their own
(:func:`build_batch_prefix`), and every operation of the backbone computes a
row the same way whatever rows share its call: on the card the products go
to G1, whose summation order the weight's shape fixes (``kernels/gemm.py``),
the norms to N1 (one CTA a row), the prefill's attention runs in calls of a
fixed batch, and K1/K2/K4/K8 plan by the widths alone.  So a request's codes
are the same bits solo or co-batched, on the CPU
(``tests/test_torch_port_serving.py``) and on the card, where
``chip_smoke.py`` ``[cobatch]`` fails if row 0 at batch 4, 8 or 64 (or the
request in every row) differs from its solo codes in any frame, on bf16 and
on int8 weights.  The hybrid's Mamba2 layers are not held to it there.

All device work (the conditioning prefix, each generate, each stream chunk,
each vocode) runs under ``device_lock``, which the server shares for speaker
embeddings: a generate captures CUDA graphs, and a capture fails if another
thread uses the card meanwhile; ``launch_counts`` is also one dict, saved and
restored around each capture.

**A sharded model** (``Zonos.shard``): requests reach rank 0, whose batcher
announces each ``generate``, stream chunk and stream close over the world
before making it (``parallel/followers.py``); every other rank runs
``zonos_tpu_torch.parallel.follow(model)``, which makes the same calls until
the batcher's ``close``.  A call that fails on any rank takes the world down:
its requests get the error, and so does every later one.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from zonos_tpu_torch.conditioning import (
    prefix_conditioner_forward,
    prepare_cond_inputs,
    required_keys,
)
from zonos_tpu_torch.config import find_multiple
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.parallel.followers import announce, leading
from zonos_tpu_torch.text import phonemize, tokenize_phonemes
from zonos_tpu_torch.text.symbols import PAD_ID

log = logging.getLogger("zonos_tpu_torch.serving")

FRAME_RATE = 86.0
EMPTY_WAV_SAMPLES = 512  # what an instant-EOS request returns: one hop of zeros


# ---------------------------------------------------------------------------
# Batched prefix conditioning
# ---------------------------------------------------------------------------


def build_batch_prefix(model, cond_dicts: list[dict], pad_multiple: int = 32) -> torch.Tensor:
    """Merge per-request cond dicts (``make_cond_dict`` outputs) into one
    ``[2B, cond_len, d_model]`` prefix (cond rows stacked over uncond rows)
    on the model's device.

    The rows share one phoneme length, left-padded up to a multiple of
    ``pad_multiple``; a request that leaves a conditioner unconditional gets
    the learned uncond vector in its row only (zonos_tpu/serving/batching.py
    ``build_batch_prefix``).  Each request's rows are computed on their own,
    as ``prepare_conditioning`` computes them: a library matmul may pick its
    kernel, and with it the order of its sums, by the row count, so a batched
    conditioner would give a request other bits than it gets alone."""
    specs = model.specs
    pc_cfg = model.config.prefix_conditioner
    pp = model.params["prefix_conditioner"]
    eps = model.config.backbone.norm_epsilon
    req_keys = required_keys(specs)

    # phonemize every text in one call; left-pad ids to the bucketed length
    texts: list[str] = []
    langs: list[str] = []
    for cd in cond_dicts:
        t, lang = cd["espeak"]
        if len(t) != 1:
            raise ValueError("one text per request (batching is across requests)")
        texts.extend(t)
        langs.extend(lang)
    ids, _ = tokenize_phonemes(phonemize(texts, langs))
    L = ids.shape[1]
    Lp = -(-L // pad_multiple) * pad_multiple
    ids_padded = np.full((len(cond_dicts), Lp), PAD_ID, np.int32)
    ids_padded[:, Lp - L:] = ids

    def inputs(i: int, cd: dict, uncond: bool) -> dict:
        """The request's conditioner inputs, as ``prepare_cond_inputs`` makes
        them (the uncond side keeps only the required keys)."""
        out = {}
        for spec in specs:
            v = cd.get(spec.name) if (not uncond or spec.name in req_keys) else None
            if spec.type == "Espeak":
                v = ids_padded[i:i + 1]
            elif v is None and spec.name in req_keys:
                raise ValueError(f"Missing required conditioning key: {spec.name}")
            elif v is not None:
                v = (np.asarray(v, np.int32).reshape(1, 1, -1) if spec.type == "Integer"
                     else np.asarray(v, np.float32))
            out[spec.name] = v
        return out

    rows = [[prefix_conditioner_forward(pp, specs, pc_cfg, inputs(i, cd, uncond), eps)
             for uncond in (False, True)] for i, cd in enumerate(cond_dicts)]
    dtype = rows[0][0].dtype
    for r in rows:
        dtype = torch.promote_types(dtype, torch.promote_types(r[0].dtype, r[1].dtype))
    return torch.cat([r[0].to(dtype) for r in rows] + [r[1].to(dtype) for r in rows], dim=0)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


def _row_inputs(batch: list, Bp: int):
    """Per-request seeds and (optional) stacked audio-prefix codes [Bp, K, P],
    padded to the batch bucket by repeating the last row (padding rows are
    muted or dropped on the host).  The requests of a batch share a prefix
    length (``BatchKey``), and a zero-length prefix counts as none, so a
    batch holds prefixes in every row or in none."""
    seeds = [int(r.seed) for r, _ in batch]
    seeds += [seeds[-1]] * (Bp - len(batch))
    if _prefix_len(batch[0][0].audio_prefix_codes) == 0:
        return seeds, None
    rows = [np.asarray(r.audio_prefix_codes, np.int64) for r, _ in batch]
    return seeds, np.stack(rows + [rows[-1]] * (Bp - len(batch)))


def _prefix_len(codes) -> int:
    return 0 if codes is None else int(np.shape(codes)[-1])


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """Requests sharing a key may run in one device batch; the scheduler also
    groups by each request's own padded conditioning length
    (``ContinuousBatcher._cond_bucket``), so co-batching never changes a
    request's prefix padding.

    Duration is not part of the key: per-sample frame caps are
    ``Zonos.generate(step_limits=...)``, so a 5-second and a 25-second
    request share a batch sized by a bucketed maximum, each trimmed to its
    own cap.  ``stream`` is ``None`` for whole-utterance requests; streaming
    requests carry their (chunk_frames, margin_frames) so co-batched streams
    share one emission cadence.  ``prefix_len`` is the audio-prefix length in
    frames: the batched prefix has one length (long-form carry uses one
    fixed ``carry_frames``, so its segments share a bucket)."""

    sampling: SamplingParams
    cfg_scale: float
    stream: tuple | None = None
    prefix_len: int = 0


class ServerOverloaded(RuntimeError):
    """Admission rejected: the request queue is at capacity.  The server maps
    this to HTTP 503 with a Retry-After header."""

    def __init__(self, depth: int, limit: int, retry_after: float):
        super().__init__(f"server overloaded: {depth} requests in flight (limit {limit})")
        self.retry_after = retry_after


@dataclasses.dataclass
class TTSRequest:
    cond_dict: dict  # make_cond_dict output (one text)
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    cfg_scale: float = 2.0
    seed: int = 423
    max_new_tokens: int = 86 * 30
    # skip per-utterance post-processing (loudness, trim_silence, fade_in_out)
    # and return the raw decoded waveform: long-form parallel segments need
    # this, or a fade and a silence trim would land at every seam
    raw_decode: bool = False
    # seconds from submit: a request still queued at its deadline fails with
    # TimeoutError; a streaming request past it is cancelled mid-flight
    deadline_s: float | None = None
    # audio-prefix codes [K, P] this request continues from; requests sharing
    # a prefix length co-batch; the prefix frames are not part of the output
    audio_prefix_codes: np.ndarray | None = None
    # return the generated codes [K, T] instead of a waveform (the long-form
    # carry path threads the seam prefix and vocodes each segment with it)
    codes_only: bool = False

    @property
    def key(self) -> BatchKey:
        return BatchKey(self.sampling, float(self.cfg_scale),
                        prefix_len=_prefix_len(self.audio_prefix_codes))


@dataclasses.dataclass
class StreamRequest(TTSRequest):
    """A request whose audio is delivered incrementally (``StreamHandle``).
    Co-submitted streams with the same key ride one batched decode;
    independently arriving stream groups interleave chunk by chunk (the
    batcher takes the device lock per decode chunk, not per stream)."""

    chunk_frames: int = 43  # ~0.5 s of audio per emitted chunk
    margin_frames: int = 32  # vocoder context on each side of a window

    @property
    def key(self) -> BatchKey:
        return BatchKey(self.sampling, float(self.cfg_scale),
                        (int(self.chunk_frames), int(self.margin_frames)),
                        prefix_len=_prefix_len(self.audio_prefix_codes))


class StreamHandle:
    """Consumer side of one streaming request: an iterator of float32
    waveform chunks (44.1 kHz) plus a cancel signal.

    ``cancel()`` stops delivery at once; the batch the stream rides keeps
    decoding for its peers, but when every stream of the group is cancelled
    the batcher closes the generator and frees the card."""

    _DONE = object()

    def __init__(self):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._cancelled = threading.Event()
        self._submitted = time.monotonic()
        self.first_chunk_s: float | None = None  # time to first audio, set by the batcher
        self._deadline: float | None = None  # absolute monotonic, from submit
        self._on_done = None  # the batcher's in-flight accounting (called once)

    def cancel(self):
        self._cancelled.set()

    def _set(self, wav=None, error=None):
        """The failure surface shared with PendingResult."""
        if error is not None:
            self._put(error)
        self._put(self._DONE)

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def _put(self, item):
        if item is self._DONE and self._on_done is not None:
            cb, self._on_done = self._on_done, None
            cb()
        self._q.put(item)

    def chunks(self, timeout: float | None = 600.0):
        """Yield waveform chunks until the stream ends.  Raises the producer's
        error, if any, and ``TimeoutError`` when no chunk arrives in
        ``timeout`` seconds."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("no stream chunk arrived in time") from None
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


MAX_FRAMES = 86 * 30  # model hard cap (zonos/model.py:229)


def program_frames_bucket(n: int) -> int:
    """Snap a requested frame count to the step-budget bucket (512-frame
    steps, capped at the 30-s maximum), as JAX's batcher does; the budget
    sets the cache and the step count, so the offline long-form path and the
    server's must bucket alike to give the same audio."""
    n = min(max(int(n), 1), MAX_FRAMES)
    return MAX_FRAMES if n > 2048 else find_multiple(n, 512)


def _startup_widths(chunk_frames: int, margin_frames: int, K: int) -> set[int]:
    """Replay stream_generate_batch's steady-emission arithmetic (no EOS) to
    enumerate the unbucketed vocode widths of a stream's first chunks: while
    the frames available are fewer than one 32-bucket past the window start,
    the start clamps to 0 and the width is the raw available length.
    Deterministic in (chunk_frames, margin_frames, num_codebooks): avail after
    n chunks = 1 + n * chunk_frames - K."""
    widths: set[int] = set()
    emitted = 0
    for n in range(1, 256):
        avail = 1 + n * chunk_frames - K
        if avail - margin_frames <= emitted:
            continue
        w0_raw = max(0, emitted - margin_frames)
        bucket = -(-(avail - w0_raw) // 32) * 32
        w0 = max(0, avail - bucket)
        width = avail - w0
        # no early break: a width can be a 32-multiple by coincidence while the
        # window start still clamps to 0, with unbucketed widths after it
        if width % 32:
            widths.add(width)
        emitted = avail - margin_frames
    return widths


class PendingResult:
    """Future for one submitted request."""

    def __init__(self):
        self._event = threading.Event()
        self._wav: np.ndarray | None = None
        self._error: BaseException | None = None
        self._deadline: float | None = None  # absolute monotonic
        self._on_done = None  # the batcher's in-flight accounting (called once)

    def _set(self, wav=None, error=None):
        self._wav, self._error = wav, error
        if self._on_done is not None:
            cb, self._on_done = self._on_done, None
            cb()
        self._event.set()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        """Block until done; returns the waveform ``[1, samples]`` float32 at
        44.1 kHz (loudness-normalized, trimmed, faded), or the codes [K, T]
        of a ``codes_only`` request."""
        if not self._event.wait(timeout):
            raise TimeoutError("synthesis did not complete in time")
        if self._error is not None:
            raise self._error
        return self._wav


class ContinuousBatcher:
    """Background scheduler merging requests into bucketed device batches.

    ``stats`` also counts ``capture_seconds``: the CUDA-graph captures the
    batches' generates paid (each generate captures its own graphs)."""

    def __init__(
        self,
        model,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
        cond_pad_multiple: int = 32,
        batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
        device_lock: threading.Lock | None = None,
        max_queue: int = 64,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.cond_pad_multiple = cond_pad_multiple
        # requests in flight (queued + generating) beyond which submit() and
        # submit_stream() raise ServerOverloaded (HTTP 503)
        self.max_queue = max_queue
        self._inflight = 0
        # serializes device work against other users of the card (the server
        # shares its lock through this parameter)
        self.device_lock = device_lock or threading.Lock()
        self.batch_buckets = (tuple(sorted(b for b in batch_buckets if b <= max_batch))
                              or (max_batch,))
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._latencies: list[float] = []  # submit -> result, seconds (ring)
        self.stats = {
            "requests": 0,
            "completed": 0,
            "failed": 0,
            "batches": 0,
            "max_batch_seen": 0,
            "audio_seconds": 0.0,
            "generate_seconds": 0.0,
            "capture_seconds": 0.0,
            "streams": 0,
            "rejected": 0,  # admission-control 503s
            "expired": 0,  # deadline_s elapsed before device work started
        }
        self._ttfa: list[float] = []  # stream submit -> first chunk, s (ring)
        self._stream_threads: list[threading.Thread] = []
        self._stream_ids = itertools.count()
        self._thread = threading.Thread(target=self._run, name="tts-batcher", daemon=True)
        self._thread.start()

    # -- public api --------------------------------------------------------
    def _warm_generates(self, cond_lens, max_new_tokens, sampling, use_cfg,
                        prefix_audio_lens) -> int:
        """Load every kernel library (on the card) and run one generate of a
        single step per batch bucket, padded cond length and prefix length."""
        model = self.model
        frames = max_new_tokens if isinstance(max_new_tokens, int) else min(max_new_tokens)
        K, d = model.config.num_codebooks, model.config.backbone.d_model
        count = 0
        with self.device_lock:
            if model.device.type == "cuda":
                from zonos_tpu_torch.kernels import load_all

                load_all(model.device.index or 0)
            for B in self.batch_buckets:
                for cond_len in cond_lens:
                    for plen in prefix_audio_lens:
                        prefix = torch.zeros((2 * B, cond_len, d), dtype=model.compute_dtype,
                                             device=model.device)
                        apc = None if plen == 0 else np.zeros((B, K, plen), np.int64)
                        self._generate(prefix_conditioning=prefix, audio_prefix_codes=apc,
                                       max_new_tokens=frames,
                                       cfg_scale=2.0 if use_cfg else 1.0, batch_size=B,
                                       sampling_params=sampling or SamplingParams(), seed=0,
                                       progress_bar=False, step_limits=1)
                        count += 1
        return count

    def warmup(
        self,
        cond_lens: tuple[int, ...] = (32, 64),
        max_new_tokens: int | tuple[int, ...] = (512, 1024, 1536, 2048, 86 * 30),
        sampling: SamplingParams | None = None,
        use_cfg: bool = True,
        prefix_audio_lens: tuple[int, ...] = (0,),
    ) -> int:
        """Warm what steady-state serving will use.  JAX's version compiles
        the decode programs ahead of traffic.  The port has no program to
        compile (its kernels are built once; each generate captures its own
        CUDA graphs, kept for that generate only), so this loads every
        kernel library on the card, with each kernel's attributes set, and
        runs one generate of a single step for every batch bucket, padded
        cond length in ``cond_lens`` and audio-prefix length in
        ``prefix_audio_lens``, at the shortest budget of ``max_new_tokens``:
        the cuBLAS handles, the allocator's blocks and the first launches are
        then paid before traffic.  Returns how many generates ran."""
        return self._warm_generates(cond_lens, max_new_tokens, sampling, use_cfg,
                                    prefix_audio_lens)

    def warmup_streaming(
        self,
        cond_lens: tuple[int, ...] = (32, 64),
        max_new_tokens: int | tuple[int, ...] = (512, 2048),
        chunk_frames: int = 43,
        margin_frames: int = 32,
        sampling: SamplingParams | None = None,
        use_cfg: bool = True,
    ) -> int:
        """The streaming counterpart of :meth:`warmup`: one generate of a
        single step per batch bucket and cond length, then one DAC decode per
        vocode window a stream can emit (every 32-frame width up to the steady
        window, and the unbucketed start-up widths of
        :func:`_startup_widths`), at the batched and the one-row batch
        dimension.  Returns how many generates and decodes ran."""
        count = self._warm_generates(cond_lens, max_new_tokens, sampling, use_cfg, (0,))
        K = self.model.config.num_codebooks
        steady = -(-(chunk_frames + 2 * margin_frames) // 32) * 32
        widths = set(range(32, steady + 32, 32)) | _startup_widths(chunk_frames, margin_frames, K)
        with self.device_lock:
            ae = self.model.autoencoder
            for B in self.batch_buckets:
                for width in sorted(widths):
                    for rows in sorted({B, 1}):
                        ae.decode(np.zeros((rows, K, width), np.int64))
                        count += 1
        return count

    def _admit(self, request, result) -> None:
        """Admission control: count the request in flight or raise
        ServerOverloaded (the result's _on_done, which fires exactly once on
        every completion path, counts it out)."""
        with self._stats_lock:
            if self._inflight >= self.max_queue:
                self.stats["rejected"] += 1
                lat = sorted(self._latencies)
                retry = lat[len(lat) // 2] if lat else 1.0
                raise ServerOverloaded(self._inflight, self.max_queue,
                                       retry_after=max(1.0, retry))
            self._inflight += 1
            self.stats["requests"] += 1
        result._on_done = self._request_done
        if request.deadline_s is not None:
            result._deadline = result._submitted + float(request.deadline_s)

    def _request_done(self) -> None:
        with self._stats_lock:
            self._inflight -= 1

    def submit(self, request: TTSRequest) -> PendingResult:
        pending = PendingResult()
        pending._submitted = time.monotonic()
        self._admit(request, pending)
        self._q.put((request, pending))
        return pending

    def synthesize(self, request: TTSRequest, timeout: float | None = None) -> np.ndarray:
        return self.submit(request).wait(timeout)

    def submit_stream(self, request: StreamRequest) -> StreamHandle:
        """Submit a streaming request; returns at once.  Iterate
        ``handle.chunks()`` for the audio.  Streams arriving inside one batch
        window share a batch; separate stream groups (and whole-utterance
        batches) interleave between decode chunks."""
        handle = StreamHandle()
        self._admit(request, handle)
        self._q.put((request, handle))
        return handle

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        for t in self._stream_threads:
            t.join(timeout=5)
        with self.device_lock:
            announce(self.model, "stop")

    # -- a sharded model's calls: announced to the followers first ---------
    def _generate(self, **kwargs) -> list:
        """``model.generate``; over a mesh rank 0 announces the call first
        (``parallel/followers.py``), so every rank makes it, and a failure
        takes the world down."""
        announce(self.model, "generate", kwargs=kwargs)
        with leading(self.model):
            return self.model.generate(**kwargs)

    def _stream(self, **kwargs):
        """``model.stream_generate_batch``; over a mesh each chunk and the
        close are announced first (call ``next`` and ``close`` under the
        device lock, as for any stream)."""
        sid = next(self._stream_ids)
        gen = self.model.stream_generate_batch(**kwargs)
        opened = False
        try:
            while True:
                if not opened:
                    announce(self.model, "stream", sid, kwargs)
                    opened = True
                announce(self.model, "next", sid)
                with leading(self.model):
                    events = next(gen, None)
                if events is None:
                    return
                yield events
        finally:
            if opened:
                announce(self.model, "close", sid)
            gen.close()

    def snapshot(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
            lat = sorted(self._latencies)
            ttfa = sorted(self._ttfa)
            s["inflight"] = self._inflight
        s["queue_depth"] = self._q.qsize()
        s["max_queue"] = self.max_queue
        if lat:
            s["latency_p50_s"] = round(lat[len(lat) // 2], 3)
            s["latency_p95_s"] = round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 3)
        if ttfa:
            s["ttfa_p50_s"] = round(ttfa[len(ttfa) // 2], 3)
            s["ttfa_p95_s"] = round(ttfa[min(len(ttfa) - 1, int(len(ttfa) * 0.95))], 3)
        return s

    def _cond_bucket(self, request) -> int:
        """The request's own padded conditioning length (phoneme tokens rounded
        up to cond_pad_multiple), part of the grouping key: rows of one batch
        share one padded length, and a longer peer would change a request's
        prefix (left PAD rows are attended) and so its audio.  Cached on the
        request."""
        cached = getattr(request, "_cond_bucket", None)
        if cached is not None:
            return cached
        try:
            texts, langs = request.cond_dict["espeak"]
            ids, _ = tokenize_phonemes(phonemize(list(texts), list(langs)))
            m = self.cond_pad_multiple
            bucket = -(-ids.shape[1] // m) * m
        except Exception:  # malformed request: grouped; validation fails it
            bucket = -1
        request._cond_bucket = bucket
        return bucket

    # -- scheduler loop ------------------------------------------------------
    def _run(self):
        holdback: list = []  # key-mismatched items awaiting the next window
        while not self._stop.is_set():
            if holdback:
                first, first_pending = holdback.pop(0)
            else:
                try:
                    first, first_pending = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            batch = [(first, first_pending)]
            key = first.key
            gkey = (key, self._cond_bucket(first))
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                # drain compatible holdbacks first
                taken = [i for i, (r, _) in enumerate(holdback)
                         if (r.key, self._cond_bucket(r)) == gkey]
                for i in reversed(taken):
                    if len(batch) < self.max_batch:
                        batch.append(holdback.pop(i))
                remain = deadline - time.monotonic()
                if remain <= 0 or len(batch) >= self.max_batch:
                    break
                try:
                    item = self._q.get(timeout=remain)
                except queue.Empty:
                    break
                if (item[0].key, self._cond_bucket(item[0])) == gkey:
                    batch.append(item)
                else:
                    holdback.append(item)
            self._process(batch, key)

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _drop_expired(self, batch: list) -> list:
        """Fail queued items whose deadline already passed instead of spending
        a device batch on results nobody waits for."""
        now = time.monotonic()
        keep = []
        for item in batch:
            _, pending = item
            dl = pending._deadline
            if dl is not None and now > dl:
                pending._set(error=TimeoutError("deadline_s exceeded before generation started"))
                with self._stats_lock:
                    self.stats["expired"] += 1
                    self.stats["failed"] += 1
            else:
                keep.append(item)
        return keep

    def _validate(self, batch: list) -> list:
        """Per-request validation first, so that one malformed request fails
        only its own submitter instead of its whole batch."""
        good = []
        for item in batch:
            r, pending = item
            try:
                texts, _ = r.cond_dict["espeak"]
                if len(texts) != 1:
                    raise ValueError("one text per request (batching is across requests)")
                prepare_cond_inputs(self.model.specs, r.cond_dict, self.cond_pad_multiple)
                good.append(item)
            except Exception as e:  # noqa: BLE001
                pending._set(error=e)
                with self._stats_lock:
                    self.stats["failed"] += 1
        return good

    def _padded(self, batch: list) -> tuple[int, list[dict], list[int]]:
        """The batch bucket, and the cond dicts and step limits padded to it
        (padding rows repeat the last request's conditioning and stop at once)."""
        B = len(batch)
        Bp = self._bucket(B)
        cond_dicts = [r.cond_dict for r, _ in batch]
        cond_dicts += [cond_dicts[-1]] * (Bp - B)
        limits = [int(r.max_new_tokens) for r, _ in batch] + [1] * (Bp - B)
        return Bp, cond_dicts, limits

    def _capture_s(self) -> float:
        stats = self.model.decode_stats
        return float(stats["capture_s"]) if stats else 0.0

    def _decode_one(self, r: TTSRequest, codes: np.ndarray) -> np.ndarray:
        """One request's output from its codes.  An instant-EOS request has no
        codes: it gets one hop of zeros, never a DAC decode of 0 frames."""
        if r.codes_only:
            return np.asarray(codes)  # [K, T] int codes
        ae = self.model.autoencoder
        if codes.shape[-1] == 0:
            return np.zeros((1, EMPTY_WAV_SAMPLES), np.float32)
        if r.raw_decode:
            return np.asarray(ae.decode(np.asarray(codes)[None, ...])[0])
        return ae.codes_to_wavs([codes])[0]

    def _process(self, batch: list, key: BatchKey):
        if key.stream is not None:
            # a stream group lives as long as its longest stream: running it on
            # the scheduler thread would queue every later request behind it;
            # each group gets a worker thread, the per-chunk device_lock is the
            # only serialization
            self._stream_threads = [t for t in self._stream_threads if t.is_alive()]
            t = threading.Thread(target=self._process_stream, args=(batch, key),
                                 name="tts-stream-group", daemon=True)
            self._stream_threads.append(t)
            t.start()
            return
        batch = self._validate(self._drop_expired(batch))
        if not batch:
            return
        try:
            B = len(batch)
            Bp, cond_dicts, limits = self._padded(batch)
            t0 = time.monotonic()
            # the whole device section (conditioner, decode, vocode) under the lock
            with self.device_lock:
                prefix = build_batch_prefix(self.model, cond_dicts, self.cond_pad_multiple)
                # each row's noise is keyed by its own request's seed (padding
                # rows reuse the last seed and are dropped)
                seeds, apc = _row_inputs(batch, Bp)
                # JAX's batcher passes default_cache_growth here; the port has no
                # cache growth: K1/K2 read the cache only up to its length
                # (kernels/decode_attention.py band_plan), so a long cache costs
                # nothing per step
                codes = self._generate(
                    prefix_conditioning=prefix,
                    audio_prefix_codes=apc,
                    batch_size=Bp,
                    max_new_tokens=program_frames_bucket(max(limits)),
                    cfg_scale=key.cfg_scale,
                    sampling_params=key.sampling,
                    seed=seeds,
                    progress_bar=False,
                    step_limits=limits,
                )
                capture_s = self._capture_s()
                results = [self._decode_one(r, c) for (r, _), c in zip(batch, codes[:B])]
            gen_s = time.monotonic() - t0
            audio_s = 0.0
            lat = []
            outs = []
            for (r, pending), out in zip(batch, results):
                audio_s += (out.shape[-1] / FRAME_RATE if r.codes_only
                            else out.shape[-1] / 44100.0)
                outs.append((pending, out))
                lat.append(time.monotonic() - pending._submitted)
            # stats before results: a client that wakes on its result and
            # snapshots at once must see this batch's counters
            with self._stats_lock:
                self.stats["completed"] += B
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], B)
                self.stats["audio_seconds"] += audio_s
                self.stats["generate_seconds"] += gen_s
                self.stats["capture_seconds"] += capture_s
                self._latencies = (self._latencies + lat)[-1024:]
            for pending, wav in outs:
                pending._set(wav=wav)
        except Exception as e:  # noqa: BLE001 — the scheduler keeps running; report to all waiters
            log.exception("batch of %d failed", len(batch))
            for _, pending in batch:
                pending._set(error=e)
            with self._stats_lock:
                self.stats["failed"] += len(batch)

    def _process_stream(self, batch: list, key: BatchKey):
        """Run one group of streaming requests as one batched decode.

        The device lock is taken per decode chunk (and for the prefix and
        the generator's close), never for the whole stream: another stream
        group, or a whole-utterance batch, runs its device work between this
        group's chunks."""
        batch = self._validate(self._drop_expired(batch))
        if not batch:
            return
        handles: list[StreamHandle] = [h for _, h in batch]
        try:
            B = len(batch)
            Bp, cond_dicts, limits = self._padded(batch)
            chunk_frames, margin_frames = key.stream
            t0 = time.monotonic()
            with self.device_lock:
                prefix = build_batch_prefix(self.model, cond_dicts, self.cond_pad_multiple)
            seeds, apc = _row_inputs(batch, Bp)
            gen = self._stream(
                prefix_conditioning=prefix,
                audio_prefix_codes=apc,
                batch_size=Bp,
                max_new_tokens=program_frames_bucket(max(limits)),
                cfg_scale=key.cfg_scale,
                sampling_params=key.sampling,
                seed=seeds,
                step_limits=limits,
                chunk_frames=chunk_frames,
                margin_frames=margin_frames,
                active_rows=[True] * B + [False] * (Bp - B),
            )
            audio_s = capture_s = 0.0
            expired: set[int] = set()
            try:
                while True:
                    now = time.monotonic()
                    for i, h in enumerate(handles):
                        # mid-flight deadline: unblock the client and stop
                        # delivering; once every row is cancelled or expired
                        # the group closes and frees the card
                        if (i not in expired and h._deadline is not None
                                and now > h._deadline and not h.cancelled):
                            expired.add(i)
                            h.cancel()
                            h._put(TimeoutError("deadline_s exceeded mid-stream"))
                    if self._stop.is_set() or all(h.cancelled for h in handles):
                        break  # shutdown / nobody listening: free the card
                    with self.device_lock:  # one decode chunk and its vocode
                        events = next(gen, None)
                        if events is not None:  # decode_stats are this group's
                            capture_s = self._capture_s()
                    if events is None:
                        break
                    now = time.monotonic()
                    for row, wav in events:
                        if row >= B or handles[row].cancelled:
                            continue  # padding row / abandoned stream
                        h = handles[row]
                        if h.first_chunk_s is None:
                            h.first_chunk_s = now - h._submitted
                        audio_s += wav.shape[-1] / 44100.0
                        h._put(np.asarray(wav, np.float32))
            finally:
                with self.device_lock:  # frees the group's graphs and cache
                    gen.close()
                    del gen
            gen_s = time.monotonic() - t0
            for h in handles:
                h._put(StreamHandle._DONE)
            ttfa = [h.first_chunk_s for h in handles if h.first_chunk_s is not None]
            with self._stats_lock:
                self.stats["completed"] += B - len(expired)
                self.stats["expired"] += len(expired)
                self.stats["failed"] += len(expired)
                self.stats["streams"] += B
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], B)
                self.stats["audio_seconds"] += audio_s
                self.stats["generate_seconds"] += gen_s
                self.stats["capture_seconds"] += capture_s
                self._ttfa = (self._ttfa + ttfa)[-1024:]
        except Exception as e:  # noqa: BLE001 — report to all listeners
            log.exception("stream group of %d failed", len(handles))
            for h in handles:
                h._put(e)
                h._put(StreamHandle._DONE)
            with self._stats_lock:
                self.stats["failed"] += len(handles)
