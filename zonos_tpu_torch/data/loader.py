"""Batch assembly and a prefetching loader for training
(zonos_tpu/data/loader.py).

- **Bucketed shapes**: every batch is padded to bucketed lengths (phonemes to
  a multiple of ``phoneme_bucket``, codes to ``code_bucket``), so a run sees
  few distinct shapes.  Phoneme ids are LEFT-padded with the PAD symbol (the
  reference's own intra-batch padding, zonos/conditioning.py:186-191); codes
  are right-padded with the mask token, whose targets the loss excludes
  (``parallel/train.py`` ``multicodebook_loss``).
- **Length-pooled batching**: examples are shuffled, then sorted by code
  length inside pools of ``pool_factor`` batches and cut: batches are
  near-homogeneous in length while staying stochastic across epochs.
  Deterministic in (seed, epoch), with numpy's generator as the JAX package
  draws it, so both packages make the same batches.
- **Prefetch**: a background thread assembles numpy batches and (with
  ``device_put_fn``) moves them to the device while the step runs.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from zonos_tpu_torch.data.dataset import PreparedExample
from zonos_tpu_torch.text.symbols import PAD_ID


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass
class BatchSpec:
    batch_size: int = 8
    phoneme_bucket: int = 16
    code_bucket: int = 64
    pool_factor: int = 8  # batches per sort pool
    max_code_len: int | None = None  # drop/truncate overlong clips
    eos_token_id: int | None = None  # append an EOS frame after each clip's codes


def assemble_batch(
    items: Sequence[PreparedExample],
    specs,
    mask_token_id: int,
    spec_cfg: BatchSpec,
) -> dict:
    """-> {"cond_inputs": {name: [B,...] or None}, "codes": [B,K,Tc]}, numpy.

    ``specs`` is the model's conditioner spec tuple; inputs are emitted only
    for conditioners the model actually has, keyed the way
    `prefix_conditioner_forward` consumes them."""
    B = len(items)
    eos_extra = 1 if spec_cfg.eos_token_id is not None else 0
    T_ph = _round_up(max(len(p.phonemes) for p in items), spec_cfg.phoneme_bucket)
    T_c = _round_up(max(p.codes.shape[-1] for p in items) + eos_extra,
                    spec_cfg.code_bucket)
    K = items[0].codes.shape[0]

    phonemes = np.full((B, T_ph), PAD_ID, np.int32)
    codes = np.full((B, K, T_c), mask_token_id, np.int32)
    for i, p in enumerate(items):
        phonemes[i, T_ph - len(p.phonemes):] = p.phonemes  # left pad
        t = p.codes.shape[-1]
        codes[i, :, :t] = p.codes  # right pad with mask id
        if eos_extra:
            # the stop target: an EOS frame terminates every clip, so the
            # model learns the EOS emission the decode loop's choreography
            # expects (ref model.py:336-414)
            codes[i, :, t] = spec_cfg.eos_token_id

    cond_inputs: dict = {}
    for s in specs:
        if s.name == "espeak":
            cond_inputs[s.name] = phonemes
        elif s.name == "speaker":
            if items[0].speaker is None:
                cond_inputs[s.name] = None  # learned uncond vector
            else:
                cond_inputs[s.name] = np.stack([p.speaker for p in items])  # [B,1,128]
        elif s.name in items[0].values:
            v = np.stack([p.values[s.name] for p in items])  # [B,1,dim]
            if s.type == "Integer":
                v = v.astype(np.int32)
            cond_inputs[s.name] = v
        else:
            cond_inputs[s.name] = None
    return {"cond_inputs": cond_inputs, "codes": codes}


def iter_epoch_batches(
    prepared: Sequence[PreparedExample],
    specs,
    mask_token_id: int,
    spec_cfg: BatchSpec,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[dict]:
    """Deterministic length-pooled batches for one epoch.

    A trailing partial batch is padded up to ``batch_size`` by wrapping
    examples from the epoch (keeps the compiled step's batch shape unique;
    repeated rows are ordinary data)."""
    prepared = [p for p in prepared
                if spec_cfg.max_code_len is None
                or p.codes.shape[-1] <= spec_cfg.max_code_len]
    if not prepared:
        return
    rng = np.random.default_rng((seed, epoch))
    order = rng.permutation(len(prepared))
    B = spec_cfg.batch_size
    pool = B * spec_cfg.pool_factor

    batches: list[list[int]] = []
    for start in range(0, len(order), pool):
        chunk = sorted(order[start:start + pool],
                       key=lambda i: prepared[i].codes.shape[-1])
        batches.extend(chunk[i:i + B] for i in range(0, len(chunk), B))
    rng.shuffle(batches)

    for idxs in batches:
        idxs = list(idxs)
        wrap = 0
        while len(idxs) < B:  # wrap the epoch to fill the last batch
            idxs.append(int(order[wrap % len(order)]))
            wrap += 1
        yield assemble_batch([prepared[i] for i in idxs], specs, mask_token_id,
                             spec_cfg)


class PrefetchLoader:
    """Endless epoch-looping loader with a background prefetch thread.

    ``device_put_fn(batch_dict) -> batch_dict`` runs inside the worker thread
    (for example one that moves the arrays to the card, so the copy overlaps
    the step).  Iteration yields ``(step_index, batch)`` forever; bound it with
    ``itertools.islice`` or a step counter.  ``start_step`` fast-forwards the
    shuffle so a resumed job sees the data stream it would have seen."""

    def __init__(self, prepared, specs, mask_token_id, spec_cfg: BatchSpec,
                 seed: int = 0, prefetch: int = 2, device_put_fn=None,
                 start_step: int = 0):
        self.prepared = list(prepared)
        self.specs = specs
        self.mask_token_id = mask_token_id
        self.spec_cfg = spec_cfg
        self.seed = seed
        self.prefetch = prefetch
        self.device_put_fn = device_put_fn
        self.start_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _worker(self):
        # fast-forward whole epochs by arithmetic: batches-per-epoch is
        # deterministic (ceil(n_filtered / B) — trailing batch wrapped), so a
        # resume at a large start_step skips straight to the target epoch
        # instead of assembling and discarding every earlier batch
        n = len([p for p in self.prepared
                 if self.spec_cfg.max_code_len is None
                 or p.codes.shape[-1] <= self.spec_cfg.max_code_len])
        per_epoch = -(-n // self.spec_cfg.batch_size) if n else 0
        if per_epoch and self.start_step >= per_epoch:
            epoch = self.start_step // per_epoch
            step = epoch * per_epoch
        else:
            step = 0
            epoch = 0
        try:
            while not self._stop.is_set():
                produced = False
                for batch in iter_epoch_batches(
                    self.prepared, self.specs, self.mask_token_id,
                    self.spec_cfg, self.seed, epoch,
                ):
                    produced = True
                    if step >= self.start_step:
                        if self.device_put_fn is not None:
                            batch = self.device_put_fn(batch)
                        while not self._stop.is_set():
                            try:
                                self._q.put((step, batch), timeout=0.2)
                                break
                            except queue.Full:
                                continue
                    step += 1
                    if self._stop.is_set():
                        return
                if not produced:
                    raise ValueError("no examples to batch (empty or all filtered)")
                epoch += 1
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
            self._q.put(None)

    def __iter__(self):
        if self._stop.is_set():
            raise RuntimeError("PrefetchLoader already stopped — create a "
                               "new loader (a fresh one also re-seeds "
                               "deterministically)")
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is None:
                    raise RuntimeError("loader worker failed") from self._err
                yield item
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        try:  # unblock a worker waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
