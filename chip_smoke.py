#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zonos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles every kernel under zonos_tpu_torch/csrc/ (one nvcc per
   source, in parallel) and prints the build time.
3. kernels: holds each kernel (K1-K8, G1 and N1, and K1/K2 over f8 and int8
   caches) against its plain PyTorch version on the same inputs at flagship
   shapes
   (K3 over both of its routes, batch 1, 4 and 64 and every branch of its
   function; K6 at L 1 to 1024, batch 16 and two groups at widths that are
   not tile multiples, and a row alone, at batch 2 and inside batch 16 bit
   for bit; K7 over int8 and int4 states at batch 1 and 8 with CFG, and a
   row alone against it inside batch 8; K5 also at the DAC encoder's
   residual units of a 3-s clip; G1 on every weight ``matmul_w`` gives it,
   bf16 and int8, at 1 to 64 x 142 rows, a request's rows alone and first
   in a batch bit for bit, and N1 likewise; G1 and K8 with a layer's norm
   folded in against N1 and then the product, bit for bit, at every tile
   choice; K1 and K2 by every grid their split allows, bit for bit), with
   the tolerance stated beside each check; then the autograd routes of G1,
   N1 and K6 at training shapes against ``torch.autograd`` through the plain
   versions (every input gradient the plain route's bits).
4. main paths, each with the launch counts zeroed just before and read just
   after (a CUDA graph's launches counted at every replay), each failing if
   a kernel of that path did not launch or if a generate's decode did not
   run as CUDA-graph replays:
   - transformer: text -> codes -> 44.1 kHz wav on the full-width flagship
     transformer (random bf16 weights from a seed) and the full DAC (random
     fp32), at batch 1 (twice, same seed: identical codes) and at batch 4,
     260 frames each; K1, K2, K3, K5;
   - transformer int8: the same model after ``quantize_int8()``, batch 1
     twice (bf16 KV cache) and batch 4 with the int8 KV cache; K1, K2 and
     their int8 variants, K3, K4, K5;
   - transformer int4: a fresh seed-0 model after ``quantize_int4()``, batch 1
     twice (bf16 KV) and batch 4 with the f8 KV cache; K1, K2 and their f8
     variants, K3, K5, K8, and not K4;
   - hybrid: the same on the full-width, full-depth flagship Mamba2 hybrid at
     batch 1 (twice, identical codes; fp32 SSM state) and at batch 8 (16 CFG
     rows: the f8 SSM state), 430 frames each; K1, K2, K3, K5, K6, K7; then
     each prefill's wall and K6's device time in it (CUPTI);
   - hybrid int4: that model after ``quantize_int4()``, one batch-1 generate
     of 130 frames; K6, K7, K8;
   - hybrid int8: a fresh hybrid after ``quantize_int8()``, batch 8 (16 CFG
     rows), 130 frames with the SSM state in f8, int8 and int4 in turn: K7's
     int8 and int4 launches; codebook 0 of the first frame equal to the f8
     run's, the shares of equal codes printed;
   - encode: a 3-s clip made from the seed, written at 24 kHz and read back
     by ``load_prefix_audio`` twice (the same codes): K5 on the encoder;
   - prefix transformer / prefix hybrid: ``generate(audio_prefix_codes=...)``
     with those codes at batch 1, twice with one seed (identical codes, the
     prefix cut off), and on the hybrid K6's device time in the longer
     prefill;
   - stream transformer: ``stream_generate`` at batch 1 and
     ``stream_generate_batch`` at batch 4, 260 frames: codes equal to
     ``generate``'s, each row's chunks within 1e-4 x max|full| of the full
     decode; the time to first audio.
   - serve transformer: the REST server (``ServerState``, ``serve`` on
     127.0.0.1) over that model, after the batcher's ``warmup`` and
     ``warmup_streaming``: four concurrent 2-s ``/v1/tts`` requests in
     one batch, two concurrent streams, and a three-segment ``long: true``
     request whose WAV equals the offline ``synthesize_long``'s byte for
     byte; K1, K2, K3, K5; the walls, each stream's time to first audio and
     the captures' seconds. serve speakers: ``/v1/speakers`` on that server
     with the speaker files of ``[speaker]``; serve transformer int8: one
     such round after ``quantize_int8()``: K4.
   - cobatch: one request alone and as row 0 at batch 4, 8 and 64: it
     fails if any frame differs from its solo codes, or with the request in
     all 4 rows; it prints the first operation whose row-0 result differs
     (a dispatch-mode trace) and, operation by operation, a row alone
     against inside a batch (G1's products, K8, N1, the prefill's
     attention, K1, K2, K4); cobatch int8 at batch 4 and 64 after
     ``quantize_int8()`` (held the same way), cobatch hybrid at batch 4
     (held the same way, with the op-by-op trace).
   - checkpoint transformer / checkpoint hybrid: each in-memory flagship
     exported by ``export_zonos_checkpoint`` into a temporary models
     directory and read back by ``Zonos.from_pretrained``: every leaf equal
     bit for bit (the fp32 leaves rounded to bf16, the vocabulary's pad rows
     zero), a 130-token greedy generate's codes equal bit for bit; the
     file's GB, the write and load seconds, the load's peak device memory;
     K2 (and K6, K7 on the hybrid);
   - speaker: a ResNet293 and an LDA ``.pt`` in the reference's key names
     (random, from a seed) in that directory; ``make_speaker_embedding`` of
     a 10-s clip on the card within 1e-3 x max|ref| of the CPU path; the
     tower's device ms and warm wall at 3 and 10 s beside its FLOPs and
     fp32 bound;
   - quickstart: the README's quick start with every file from that
     directory (``from_pretrained``, ``load_audio``,
     ``make_speaker_embedding``, ``make_cond_dict``, ``generate`` of 260
     frames with EOS banned, ``autoencoder.save_codes`` with the DAC read
     from an HF-named ``descript/dac_44khz/model.safetensors``); K1, K2, K3,
     K5; the wall of each step;
   - apps: ``batch_cli`` over four texts, ``srt`` over a three-segment SRT
     and ``cli --verbose_sampling`` (one trace line a decode step, read at
     the polls), each through its own ``main`` and ``load_model`` on the
     files of that directory; G1, N1, K2, K3, K5; walls and WAV lengths;
   - ecapa: ECAPA-TDNN at C 1024 on a 3-s mel, the card within 1e-3 x
     max|ref| of the CPU.
   - train transformer: the full-width, full-depth flagship in bf16 on
     bench.py's training batch (2 x 896 frames, seeded conditioning for every
     conditioner): every trainable leaf's gradient present and finite, then
     2 Adafactor and 3 AdamW steps with remat on one batch, the loss falling;
     G1 and N1 launched in every step, the fold never; ms/step, frames/s,
     peak device memory, launches a step. train lora: rank-8 adapters over
     that frozen model, 5 AdamW steps: the loss falls, every base leaf keeps
     its bits. train hybrid: the full hybrid, 2 x 512 frames, 5 AdamW steps:
     K6 (with its gradient) in every step. train cli: ``train_cli.main`` on
     seeded tone clips in an LJSpeech layout (the tiny transformer in bf16):
     4 steps with validation, checkpoints and an export, K5 encoding the
     data; a resumed run encodes nothing and starts at step 4; the export
     loads through ``Zonos.from_local`` and generates 86 frames.
   - meshes (after training): mesh 1x1: the flagship transformer at bf16
     and int8 sharded on a world of one process (NCCL), batch 2, 230 tokens
     with EOS banned: codes and launches equal to the unsharded model's,
     CUDA graphs; mesh 1x2 and mesh 2x1: the same generate at bf16, int8 and
     int4 in two processes of this script (``--mesh-rank``) on the one card
     over gloo: tensor parallel (8 layers) with the prefill's CFG logits
     held to the fp32 logits of the same weights, K4 never, eager steps;
     data parallel (26 layers), each row's codes the unsharded model's
     graph-replayed codes bit for bit.
   Each path is followed by a ``[graph …]`` phase: the private eager decode
   loop and the CUDA graphs on one batch-1 generate (470 new tokens, through
   all three bands of cache lengths; 130 on the hybrid int4), same seed, EOS
   banned: their codes must be equal bit for bit; wall ms per step of each,
   capture time and graphs captured.  The bf16 and quantized transformer
   paths and the bf16 hybrid path are each followed by a profile of their
   batch-1 decode step, eager and under the graphs (the steady-state step's
   wall, the median of three pairs of generates under the graphs, one pair
   eager, and device busy time and idle share, top kernels, the port's
   kernels' ms per step); the int8 path
   also by one at batch 64 with the f8 KV cache (K4 at 128 rows).
5. timings: each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, median of CUDA-event
   timings; prints the ``{"kernels": [...]}`` line, one entry per kernel,
   with further shapes under ``"more"`` (G1, N1 and K6 also at the training
   phases' shapes, each with its autograd backward's time and its launches
   a training step).

``python3 chip_smoke.py --sweep`` runs phases 1-2, breaks one K8 call's
device time down (kernel, memset, timing floor) and one K4 call's by launch,
and then times K8 and K4 over their contraction splits, K7 over its slab
sizes, K2 and K1 over their cluster sizes by cache length, K5 over its
tile shapes by DAC width, K3 over its rows a CTA and K6 over its plans
(warps, cluster size) instead (how their defaults were chosen;
K2's also with its band's own launch).

``python3 chip_smoke.py --times [--port DIR]`` runs phases 1-2 and only the
timed rows of K1, K2, K5, K3 and K6 with a breakdown of a K1 call by launch
and K3's and K6's own time a launch (CUPTI).  ``python3 chip_smoke.py --profile [--port
DIR]`` runs phases 1-2 and only the steady-state decode step under the CUDA
graphs at batch 1 on the transformer (bf16, int8, int4) and the hybrid
(wall, device busy, idle share), with no checks; each path folded, unfolded
(N1 then the product) and folded again where the port folds its norms.
With ``--port DIR`` either
imports the port from DIR, a checkout of another commit, so that two
commits are timed by the same code on one card (a checkout whose K1/K2 take
the length on the card, as this one's do; an older checkout is timed by its
own copy of this script, run from DIR).

The last line of stdout is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores (data sheet)
# K6 runs its products in 3xTF32: three TF32 products for each fp32 one
K6_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
MAX_NEW_TOKENS = 430  # ~5 s of audio at 86.13 frames/s
# The transformer path runs fewer frames to keep the script near 6 minutes;
# its cache still passes 256 rows, so K1 as well as K2 runs on it.
TRANSFORMER_NEW_TOKENS = 260
FRAMES_PER_S = 44100 / 512
SLEEP_CYCLES = 60_000_000  # ~30 ms at the H100's clock: longer than queueing a timed batch
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis is wonderful.",
    "How are you today?",
    "She sells seashells by the seashore.",
    "A state space model carries its past in a fixed-size state.",
    "Please call Stella and ask her to bring these things.",
    "It was the best of times, it was the worst of times.",
    "Rain in the morning, sunshine in the afternoon.",
]
# G1 and N1 (every bf16 or int8 product and every norm on the card) run on every path with
# bf16 or int8 weights; a decode step's layer norms run folded into G1
# ("gemm_norm") and N1 keeps the final norm (and the prefill's norms)
PRODUCT_KERNELS = ("gemm", "gemm_norm", "row_norm")
TRANSFORMER_KERNELS = ("flash_decode_attention", "decode_attention_single", "fused_sample",
                       "snake_conv1d") + PRODUCT_KERNELS
HYBRID_KERNELS = TRANSFORMER_KERNELS + ("ssd_chunked", "fused_state_step")
INT8_KERNELS = TRANSFORMER_KERNELS + ("flash_decode_attention_int8",
                                      "decode_attention_single_int8", "fused_layer_tail")
# int4 weights everywhere, the heads too: K8, no G1
INT4_KERNELS = tuple(k for k in TRANSFORMER_KERNELS if k not in ("gemm", "gemm_norm")) + (
    "flash_decode_attention_f8", "decode_attention_single_f8", "int4_matmul", "int4_matmul_norm")
HYBRID_INT4_KERNELS = ("ssd_chunked", "fused_state_step", "int4_matmul", "int4_matmul_norm",
                       "row_norm")
HYBRID_INT4_NEW_TOKENS = 130
# the [graph] phases: 470 new tokens after the smoke's 54-row prefix take the cache past 512
# rows, through K2's band and both of K1's
GRAPH_NEW_TOKENS = 470
# [encode]: a 3-s clip at 24 kHz, 132,608 samples at 44.1 kHz after preprocess = 259 frames
ENCODE_SECONDS, ENCODE_RATE, ENCODE_FRAMES = 3, 24000, 259
PREFIX_NEW_TOKENS = 130  # [prefix ...]: the generate after the 259-frame audio prefix
STREAM_BATCH = 4  # [stream transformer]: stream_generate_batch's rows
# the [mesh ...] phases: batch 2 (4 CFG rows) after a seeded 54-row prefix, EOS banned: 230
# steps take the cache past 256 rows (K2, then K1)
MESH_BATCH, MESH_COND_LEN, MESH_NEW_TOKENS, MESH_SEED = 2, 54, 230, 99
MESH_MODES = ("bf16", "int8", "int4")
MESH_TIMEOUT_S = 300
# [mesh 1x2] at full depth took 113-130 s on an H100 80GB HBM3 at 700 W (its eager steps under
# gloo ~155 ms each), over the 90 s the phase may take: its model is cut to 8 of the 26 layers
MESH_TP_LAYERS = 8
# how much further from the fp32 logits the tensor-parallel ones may be than the unsharded bf16
# model's (the second rounding of a row-parallel product's partial sums, nothing more): at 8
# layers the ratio of their largest deviations was 0.90-1.14 (PERF.md, the meshes); 1.5x of it
MESH_TP_NOISE = 1.5
# [main hybrid int8]: batch 8 (16 CFG rows), each SSM-state storage under the CUDA graphs
HYBRID_INT8_BATCH, HYBRID_INT8_NEW_TOKENS = 8, 130
# (its cache stays within 256 rows: K2, not K1)
HYBRID_INT8_KERNELS = ("ssd_chunked", "fused_sample", "decode_attention_single") + PRODUCT_KERNELS
PREFIX_KERNELS = ("flash_decode_attention", "fused_sample") + PRODUCT_KERNELS
# the flagship transformer's matmul weights [din, dout] (the heads: 9 x 1152 columns)
FLAGSHIP_WEIGHTS = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w1": (2048, 16384),
                    "w2": (8192, 2048), "heads": (2048, 10368)}
# the flagship hybrid's Mamba2 projections (its attention layers and heads have
# the transformer's shapes); in_proj's 8512 columns end in a part-filled tile
HYBRID_WEIGHTS = {"in_proj": (2048, 8512), "out_proj": (4096, 2048)}
INT4_CHECK_ROWS = (1, 2, 8, 16, 32, 64)
# G1's checks: both row tiles (16 and 64 rows), splits in parallel CTAs and in turn, ragged
# row tiles; a decode step's rows with CFG (2, 8, 128), a batch-1 prefill (142) and batch 64's
GEMM_CHECK_ROWS = (1, 2, 8, 16, 17, 128, 142, 64 * 142)
GEMM_PROBE_ROWS = (2, 142)  # G1's tile choices held against each other bit for bit
# the weights whose input is a layer norm's output: the products the norm is folded into
NORM_FED_WEIGHTS = ("wqkv", "w1", "in_proj", "out_proj")
# K8's rows with a folded norm: a decode step's, up to its FOLD_MAX_ROWS
INT4_FOLD_ROWS = (1, 2, 8, 16)
# the folded norm against N1 and then the product, timed by row count (what G1's ``folds`` was
# set from): decode steps at batch 1, 4, 8 and 64 with CFG, a batch-1 prefill
FOLD_TIMED_ROWS = (2, 8, 16, 128, 142)
# G1's timed rows: decode steps at batch 1, 4 and 64 with CFG; the batch-1 and batch-64 prefills
GEMM_TIMED_ROWS = (2, 8, 128, 142, 64 * 142)
LAYER_TAIL_CHECK_ROWS = (1, 2, 8, 64, 128)
# K2's cluster plan at its edges: one CTA (1 to 64 rows), three (65 to 96), four (97 to
# 128), five (129), six (192), seven (224), eight (255, 256) at 1 and 2 batch rows; two
# beyond 64 rows at 32 (128 pairs); one CTA a pair at 128; 1, 4 and 8 query heads a kv head
K2_CHECK_LENGTHS = (1, 31, 32, 33, 64, 65, 66, 100, 129, 192, 224, 255, 256)
K2_CHECK_BATCHES = (1, 2, 32, 128)
K2_CHECK_GROUPS = (1, 4, 8)
# K1 past 256 rows: clusters of 9 to 16 CTAs at batch 1 and 4, two to eight a pair at 128
# batch rows; 64-row (bf16) and 128-row (f8, int8) stages, one to four a rank; the held-out
# row at pos 256, 257 and S - 1
K1_CHECK_LENGTHS = (257, 511, 1000, 2000, 2047)
K1_CHECK_POS = (256, 257, 510, 999, 1999, 2047)
K1_CHECK_BATCHES = (2, 8, 128)
# K7 beyond the flagship shapes: (BH, P, N); 130 rows and P 50 end in part-filled grids
# and slabs, N 64 gives 4, 8 and 16 lanes a row
STATE_STEP_EXTRA_SHAPES = ((130, 64, 128), (128, 50, 128), (128, 64, 64))
# the batch-64 int8 profile: bench.py's rtf_batch64 configuration (int8 weights, f8 KV
# cache, CFG: 128 backbone rows), EOS banned so that every step runs all rows
B64_BATCH = 64
# K3's checks: both routes (the warp route up to 1152 entries, the CTA route past it), V not a
# multiple of 4 (1025 valid entries, 2049), batch 1, 4 and 64 (576 rows), and every branch
K3_CHECK_VOCABS = (1025, 1152, 2048, 2049, 12288)
K3_CHECK_BATCHES = (1, 4, 64)
# K3's timed shapes (B, V): batch 1 (sampling runs on the CFG-blended logits) and 64 at the
# flagship's padded vocabulary, and the CTA route at 12,288
K3_TIMED = ((1, 1152), (B64_BATCH, 1152), (1, 12288))
_K3_DEFAULT = dict(linear=0.55, conf=0.4, quad=0.0, min_p=0.0, temperature=1.0)
K3_POINTS = (("default", _K3_DEFAULT), ("min_p 0.1", {**_K3_DEFAULT, "min_p": 0.1}),
             ("T 0.7", {**_K3_DEFAULT, "temperature": 0.7}),
             ("quad 0.1", {**_K3_DEFAULT, "quad": 0.1}),
             ("linear 0", {**_K3_DEFAULT, "linear": 0.0}),
             ("linear 0, min_p 0.1", {**_K3_DEFAULT, "linear": 0.0, "min_p": 0.1}),
             # lin = linear + H conf < 0 on most rows: the warp route's reduction for raw's
             # max (and the reshaping reversed: the known rows' ids no longer hold)
             ("conf -1", {**_K3_DEFAULT, "conf": -1.0}))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_ulp(x: float) -> float:
    import math

    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def on_card(length: int, held_out: bool = False) -> tuple:
    """A cache length as the decode step hands it to K1/K2: an int32 on the
    card, and the band of the attended length (one more with the current row
    held out) that fixes the launch."""
    import torch

    from zonos_tpu_torch.kernels.decode_attention import band_of

    return (torch.full((), length, dtype=torch.int32, device="cuda"),
            band_of(length + held_out))


def device_ms(fn, calls: int = 20, reps: int = 21, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``: the median over ``reps`` of
    CUDA-event time around ``calls`` back-to-back calls, divided by
    ``calls``.  A sleep kernel holds the card first, so the host has queued
    the calls before they run and the events time the device, not the
    host's launch overhead (reported separately as host ms per call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t) * 1e3 / calls)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / calls)
    return statistics.median(dev), statistics.median(host)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(here: str) -> str:
    """Needs CUDA and the port imported from ``here`` (the checkout that holds
    this script, or ``--port DIR``); prints the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one NVIDIA card")
    try:
        import zonos_tpu_torch
    except ImportError as e:
        fail(f"cannot import the port ({e}): run this script from the repository's root")
    if os.path.dirname(os.path.dirname(os.path.abspath(zonos_tpu_torch.__file__))) != here:
        fail(f"zonos_tpu_torch was imported from {zonos_tpu_torch.__file__}, not from {here}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return card


def phase_build() -> None:
    from zonos_tpu_torch.kernels._build import build_all

    t0 = time.perf_counter()
    reports = build_all()
    print(f"[build] {len(reports)} kernel libraries compiled in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in reports.items():
        lines = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(ln.strip() for ln in lines), flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_decode_attention(gen) -> dict:
    """K1/K2 vs the plain version computed in fp32 from the same bf16 inputs.
    Tolerance: 2 bf16 ulps of the largest output magnitude (the kernel rounds
    its fp32 result to bf16 once)."""
    import torch

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_plain,
        decode_attention_single,
        flash_decode_attention,
    )

    H, Hkv, D, S = 16, 4, 128, 2048
    worst = {"flash_decode_attention": 0.0, "decode_attention_single": 0.0}
    for B in (2, 8):
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
        for length in (1, 255, 256, 257, 2000):
            ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
            tol = 2 * bf16_ulp(float(ref.abs().max()))
            for name, fn in (("flash_decode_attention", flash_decode_attention),
                             ("decode_attention_single", decode_attention_single)):
                got = fn(q, k, v, *on_card(length))
                torch.cuda.synchronize()
                err = float((got.float() - ref).abs().max())
                if not err <= tol:
                    fail(f"{name} B={B} length={length}: max abs err {err} > {tol}")
                worst[name] = max(worst[name], err)
    print(f"[kernels] K1/K2 ok at B in (2, 8), lengths (1, 255, 256, 257, 2000), S={S}: "
          f"max abs err {worst} (tolerance 2 bf16 ulps)", flush=True)
    S = 512
    for B, G in itertools.product(K2_CHECK_BATCHES, K2_CHECK_GROUPS):
        q = torch.randn((B, 1, G * Hkv, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
        for length in K2_CHECK_LENGTHS:
            ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
            got = decode_attention_single(q, k, v, *on_card(length))
            torch.cuda.synchronize()
            err = float((got.float() - ref).abs().max())
            if not err <= 2 * bf16_ulp(float(ref.abs().max())):
                fail(f"decode_attention_single B={B} G={G} length={length}: max abs err {err}")
            worst["decode_attention_single"] = max(worst["decode_attention_single"], err)
    print(f"[kernels] K2 ok at B in {K2_CHECK_BATCHES}, G in {K2_CHECK_GROUPS}, lengths "
          f"{K2_CHECK_LENGTHS}, S={S}: max abs err "
          f"{worst['decode_attention_single']:.3g} (tolerance 2 bf16 ulps)", flush=True)
    return worst


def check_flash_attention(gen, worst: dict) -> None:
    """K1 over caches past 256 rows at B in ``K1_CHECK_BATCHES`` and G 1, 4
    and 8: bf16 at ``K1_CHECK_LENGTHS`` (S 2048) and 4095 (S 4096), f8 and
    int8 with the held-out row at ``K1_CHECK_POS`` and 4095; the tolerances
    of ``check_decode_attention`` and ``check_decode_attention_quantized``.
    Updates ``worst`` in place."""
    import torch

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_plain,
        decode_attention_split_plain,
        flash_decode_attention,
        flash_decode_attention_held_out,
    )

    Hkv, D = 4, 128
    for B, G in itertools.product(K1_CHECK_BATCHES, K2_CHECK_GROUPS):
        for S, lengths in ((2048, K1_CHECK_LENGTHS), (4096, (4095,))):
            q = torch.randn((B, 1, G * Hkv, D), generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            for length in lengths:
                ref = decode_attention_plain(q.float(), k.float(), v.float(), length)
                got = flash_decode_attention(q, k, v, *on_card(length))
                torch.cuda.synchronize()
                err = float((got.float() - ref).abs().max())
                if not err <= 2 * bf16_ulp(float(ref.abs().max())):
                    fail(f"flash_decode_attention B={B} G={G} length={length}: max abs err {err}")
                worst["flash_decode_attention"] = max(worst["flash_decode_attention"], err)
            del k, v
            for storage in ("f8", "int8"):
                key = f"flash_decode_attention_{storage}"
                k, v, ks, vs = quantized_cache(gen, storage, B, Hkv, S)
                q, k_new, v_new = held_out_inputs(gen, B, G * Hkv, Hkv)
                for pos in (K1_CHECK_POS if S == 2048 else (4095,)):
                    ref = decode_attention_split_plain(q.float(), k, v, k_new.float(),
                                                       v_new.float(), pos, ks, vs)
                    pos_t, band = on_card(pos, held_out=True)
                    got = flash_decode_attention_held_out(q, k, v, k_new, v_new, pos_t, ks, vs,
                                                          band=band)
                    torch.cuda.synchronize()
                    err = float((got.float() - ref).abs().max())
                    tol = (4 if storage == "f8" else 2) * bf16_ulp(float(ref.abs().max()))
                    if not err <= tol:
                        fail(f"{key} B={B} G={G} pos={pos}: max abs err {err} > {tol}")
                    worst[key] = max(worst[key], err)
                del k, v, ks, vs
    print(f"[kernels] K1 ok at B in {K1_CHECK_BATCHES}, G in {K2_CHECK_GROUPS}: bf16 at lengths "
          f"{K1_CHECK_LENGTHS} (S 2048) and 4095 (S 4096), f8 and int8 at pos {K1_CHECK_POS} and "
          f"4095: max abs err bf16 {worst['flash_decode_attention']:.3g}, f8 "
          f"{worst['flash_decode_attention_f8']:.3g}, int8 "
          f"{worst['flash_decode_attention_int8']:.3g}", flush=True)


def k3_operands(gen, B: int, V: int, K: int = 9) -> tuple:
    """K3's logits and Gumbel noise [B, K, V] (at V 1152 the decode path's
    padding: entries from 1025 on at -inf), with two rows whose id is known:
    row (0, 0) has one finite logit, as in EOS mode, and row (0, 1) two equal
    top logits, far above the rest, with equal noise, where the lower index
    wins.  Returns (logits, noise, {(b, k): id})."""
    import torch

    from zonos_tpu_torch.ops.sampling import gumbel_of_uniform

    logits = torch.randn((B, K, V), generator=gen, device="cuda") * 3.0
    valid = 1025 if V == 1152 else V
    logits[..., valid:] = float("-inf")
    noise = gumbel_of_uniform(torch.rand((B, K, V), generator=gen, device="cuda"))
    eos, lo, hi = valid // 3, 5, valid - 7
    logits[0, 0] = float("-inf")
    logits[0, 0, eos] = 0.0
    logits[0, 1, [lo, hi]] = logits[0, 1].max() + 20.0
    noise[0, 1, [lo, hi]] = 0.0
    return logits, noise, {(0, 0): eos, (0, 1): lo}


def check_fused_sample(gen) -> float:
    """K3 vs the plain version on the same logits and Gumbel noise over
    K3_CHECK_VOCABS x K3_CHECK_BATCHES x K3_POINTS, both routes: ids must
    match except where the plain version's top two scores lie within 1e-4,
    and the EOS-mode and tied rows must give their known ids.  Then a row's id
    alone, at batch 4 and inside batch 64, and read through 4-byte loads (a
    view 4 bytes off the 16-byte alignment) must be the same.  Returns the
    largest |id difference| over all rows."""
    import torch

    from zonos_tpu_torch.kernels.sampling import (
        fused_sample,
        fused_sample_scores_plain,
        sample_plan,
    )

    worst = 0
    for V in K3_CHECK_VOCABS:
        equal = rows = ties = 0
        for B in K3_CHECK_BATCHES:
            logits, noise, known = k3_operands(gen, B, V)
            for label, kw in K3_POINTS:
                scores = fused_sample_scores_plain(logits, noise, **kw)
                ref = scores.argmax(-1)
                top2 = scores.topk(2, dim=-1).values
                near_tie = (top2[..., 0] - top2[..., 1]) < 1e-4
                got = fused_sample(logits, noise, **kw)
                torch.cuda.synchronize()
                bad = (got != ref) & ~near_tie
                if bool(bad.any()):
                    fail(f"fused_sample B={B} V={V} {label}: {int(bad.sum())} ids differ outside "
                         f"near ties")
                for (b, k), want in known.items() if kw["conf"] >= 0 else ():
                    if int(got[b, k]) != want or int(ref[b, k]) != want:
                        fail(f"fused_sample B={B} V={V} {label}: row ({b}, {k}) drew "
                             f"{int(got[b, k])} (plain {int(ref[b, k])}), not {want}")
                worst = max(worst, int((got - ref).abs().max()))
                equal += int((got == ref).sum())
                rows += got.numel()
                ties += int(near_tie.sum())
        print(f"[kernels] K3 ok V={V} ({sample_plan(V).route} route): {equal}/{rows} ids "
              f"equal at B {K3_CHECK_BATCHES} x {len(K3_POINTS)} parameter points, {ties} "
              f"near-tie rows; the EOS-mode and tied rows exact", flush=True)
    for V in (1152, 1025, 12288):
        logits, noise, _ = k3_operands(gen, 64, V)
        kw = K3_POINTS[0][1]
        ids = fused_sample(logits, noise, **kw)
        for b in (0, 37, 60):
            alone = fused_sample(logits[b:b + 1], noise[b:b + 1], **kw)
            four = fused_sample(logits[b:b + 4], noise[b:b + 4], **kw)
            # the same row 4 bytes off 16-byte alignment: the warp route's 4-byte loads
            buf = torch.empty(2 * 9 * V + 1, device="cuda")
            lg = buf[1:9 * V + 1].view(1, 9, V)
            nz = buf[9 * V + 1:].view(1, 9, V)
            lg.copy_(logits[b:b + 1])
            nz.copy_(noise[b:b + 1])
            shifted = fused_sample(lg, nz, **kw)
            if not (torch.equal(alone[0], ids[b]) and torch.equal(four[0], ids[b])
                    and torch.equal(shifted[0], ids[b])):
                fail(f"fused_sample V={V}: row {b}'s ids alone / at batch 4 / unaligned "
                     f"{alone[0].tolist()} / {four[0].tolist()} / {shifted[0].tolist()} differ "
                     f"from batch 64's {ids[b].tolist()}")
    print("[kernels] K3 ok: a row's ids alone, at batch 4, inside batch 64 and read unaligned "
          "are equal bit for bit (V 1152, 1025, 12288)", flush=True)
    return float(worst)


def residual_unit_shapes(frames: int) -> list[tuple[int, int, int]]:
    """(C, T, dilation) of every DAC decoder residual unit for ``frames``."""
    shapes = []
    for C, up in ((768, 8), (384, 64), (192, 256), (96, 512)):
        shapes += [(C, up * frames, d) for d in (1, 3, 9)]
    return shapes


def _unit_params(gen, C: int) -> dict:
    import torch

    def conv(k):
        w = torch.empty((C, C, k), device="cuda")
        torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
        return {"w": w * 0.02, "b": torch.randn((C,), generator=gen, device="cuda") * 0.01}

    alpha = lambda: 0.5 + torch.rand((C,), generator=gen, device="cuda")  # noqa: E731
    return {"alpha1": alpha(), "conv1": conv(7), "alpha2": alpha(), "conv2": conv(1)}


def check_snake_conv(gen, frames: int = 86) -> float:
    """K5 vs the plain version (fp32 cuDNN, TF32 off) at every decoder
    residual-unit shape, then at batch 2 (dilation 3) and at T = 1001, a
    multiple of no tile (dilation 9), at each width; tolerance 1e-4 x
    max|ref|."""
    import torch

    from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain

    worst = 0.0
    extra = [(C, T, 3, 2) for C, T, d in residual_unit_shapes(frames) if d == 1] + \
            [(C, 1001, 9, 1) for C, _, d in residual_unit_shapes(frames) if d == 1]
    for C, T, dil, B in [(C, T, d, 1) for C, T, d in residual_unit_shapes(frames)] + extra:
        p = _unit_params(gen, C)
        x = torch.randn((B, T, C), generator=gen, device="cuda")
        for alpha, conv, d, res in ((p["alpha1"], p["conv1"], dil, None),
                                    (p["alpha2"], p["conv2"], 1, x)):
            ref = snake_conv1d_plain(x, alpha, conv["w"], conv["b"], d, res)
            got = snake_conv1d(x, alpha, conv["w"], conv["b"], d, res)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            if not err <= tol:
                fail(f"snake_conv1d B={B} C={C} T={T} k={conv['w'].shape[-1]} dil={d}: "
                     f"max abs err {err} > {tol}")
            worst = max(worst, err / float(ref.abs().max()))
    print(f"[kernels] K5 ok at all 12 residual units x 2 convs (F={frames}), batch 2 and T 1001 "
          f"at each width: worst max-abs-err / max|ref| = {worst:.3g} (tolerance 1e-4)",
          flush=True)
    return worst


def encoder_unit_shapes(frames: int = ENCODE_FRAMES) -> list[tuple[int, int, int]]:
    """(C, T, dilation) of every DAC encoder residual unit for ``frames``
    frames: C 64 at the sample rate, then 128, 256, 512 after strides 2, 4, 8."""
    shapes, T = [], frames * 512
    for C, stride in ((64, 2), (128, 4), (256, 8), (512, 8)):
        shapes += [(C, T, d) for d in (1, 3, 9)]
        T //= stride
    return shapes


def check_snake_conv_encoder(gen) -> float:
    """K5 vs the plain version at the 12 DAC encoder residual units of a 3-s
    clip after ``preprocess`` (259 frames: T 132,608 / 66,304 / 16,576 /
    2,072 at C 64 / 128 / 256 / 512), batch 1; tolerance 1e-4 x max|ref|."""
    import torch

    from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain

    worst = 0.0
    for C, T, dil in encoder_unit_shapes():
        p = _unit_params(gen, C)
        x = torch.randn((1, T, C), generator=gen, device="cuda")
        for alpha, conv, d, res in ((p["alpha1"], p["conv1"], dil, None),
                                    (p["alpha2"], p["conv2"], 1, x)):
            ref = snake_conv1d_plain(x, alpha, conv["w"], conv["b"], d, res)
            got = snake_conv1d(x, alpha, conv["w"], conv["b"], d, res)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-4 * float(ref.abs().max()):
                fail(f"snake_conv1d encoder C={C} T={T} k={conv['w'].shape[-1]} dil={d}: "
                     f"max abs err {err}")
            worst = max(worst, err / float(ref.abs().max()))
    print(f"[kernels] K5 ok at the 12 encoder residual units x 2 convs ({ENCODE_FRAMES} frames, "
          f"C 64-512, T {encoder_unit_shapes()[0][1]}-{encoder_unit_shapes()[-1][1]}): worst "
          f"max-abs-err / max|ref| = {worst:.3g} (tolerance 1e-4)", flush=True)
    return worst


# flagship hybrid SSM widths: H heads of headdim P, d_state N, one group
SSM_H, SSM_P, SSM_N = 64, 64, 128
# K6's timed shapes (rows, L) at the flagship widths, from the zero state: the batch-1 prefill
# with CFG (its L is the smoke's: the 54-row prefix and one frame), a 1024-step prefix, and
# the [main hybrid] batch-8 prefill (16 CFG rows; its L is checked there)
K6_TIMED = ((2, 55), (2, 1024), (16, 69))
# K6's checks (rows, L, H, G, P, N), each with and without an init state: the flagship widths
# at L 1 to 1024 (sub-chunk, one chunk, a chunk and one or two rows, two chunks and one), the
# batch-8 prefill, and two groups at widths that are not tile multiples (P 20, N 12)
K6_CHECKS = ([(2, L, SSM_H, 1, SSM_P, SSM_N) for L in (1, 37, 63, 64, 65, 129, 150, 1024)]
             + [(16, 69, SSM_H, 1, SSM_P, SSM_N), (2, 70, 8, 2, 16, 16), (2, 129, 8, 2, 16, 16),
                (2, 70, 8, 2, 20, 12), (2, 129, 8, 2, 20, 12)])


def ssd_inputs(gen, B: int, L: int, H: int = SSM_H, G: int = 1, P: int = SSM_P,
               N: int = SSM_N) -> tuple:
    """x, dt, A, B, C, D, init (the flagship SSM widths by default), fp32."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (rnd(B, L, H, P), rnd(B, L, H).abs() * 0.5, -rnd(H).abs(), rnd(B, L, G, N),
            rnd(B, L, G, N), rnd(H), rnd(B, H, P, N))


def check_ssd_chunked(gen) -> float:
    """K6 vs the plain version (fp32, TF32 off) at every shape of K6_CHECKS, with
    and without an init state; tolerance 1e-4 x max|ref| for y and for the
    final state.  Then a row's outputs alone (batch 1), at batch 2 and inside
    batch 16 must be equal bit for bit (the plan depends on the widths alone).
    Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain

    worst = worst_rel = 0.0
    for rows, L, H, G, P, N in K6_CHECKS:
        x, dt, A, Bm, Cm, D, init = ssd_inputs(gen, rows, L, H, G, P, N)
        for state in (init, None):
            refs = ssd_chunked_plain(x, dt, A, Bm, Cm, D, state)
            outs = ssd_chunked(x, dt, A, Bm, Cm, D, state)
            torch.cuda.synchronize()
            for what, got, ref in zip(("y", "final state"), outs, refs):
                err = float((got - ref).abs().max())
                top = float(ref.abs().max())
                if not err <= 1e-4 * top:
                    fail(f"ssd_chunked B={rows} L={L} H={H} G={G} P={P} N={N} "
                         f"init={state is not None} {what}: max abs err {err} > 1e-4 x {top}")
                worst, worst_rel = max(worst, err), max(worst_rel, err / top)
    print(f"[kernels] K6 ok at {len(K6_CHECKS)} shapes (B, L, H, G, P, N) {K6_CHECKS}, with and "
          f"without init: max abs err {worst:.3g}, worst / max|ref| {worst_rel:.3g} "
          f"(tolerance 1e-4)", flush=True)
    x, dt, A, Bm, Cm, D, init = ssd_inputs(gen, 16, 150)

    def rows_of(t, r, n):
        return None if t is None else t[r:r + n].contiguous()

    for state in (init, None):
        y16, s16 = ssd_chunked(x, dt, A, Bm, Cm, D, state)
        for r in (0, 7, 14):
            for n in (1, 2):
                y, s = ssd_chunked(rows_of(x, r, n), rows_of(dt, r, n), A, rows_of(Bm, r, n),
                                   rows_of(Cm, r, n), D, rows_of(state, r, n))
                if not (torch.equal(y, y16[r:r + n]) and torch.equal(s, s16[r:r + n])):
                    fail(f"ssd_chunked: rows {r}..{r + n - 1} alone (batch {n}) differ from the "
                         f"same rows inside batch 16 (init={state is not None})")
    print("[kernels] K6 a row's y and final state alone, at batch 2 and inside batch 16 (L 150, "
          "with and without init): equal bit for bit", flush=True)
    return worst


def state_step_inputs(gen, BH: int, dtype, P: int = SSM_P, N: int = SSM_N) -> tuple:
    """A stored state and fp32 C, B, dA, xdt (the flagship widths by default);
    one value is pushed past the f8 range, which must store as +-448."""
    import torch

    state = (torch.randn((BH, P, N), generator=gen, device="cuda") * 4).to(dtype)
    C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
    dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
    xdt = torch.randn((BH, P), generator=gen, device="cuda")
    xdt[0, 0] = 1e4
    return state, C, B, dA, xdt


def check_fused_state_step(gen) -> float:
    """K7 vs the plain version at BH in (128, 1024), P 64, N 128, and at
    ``STATE_STEP_EXTRA_SHAPES``, for fp32, bf16 and f8 storage: y and B.C
    within 1e-5 x max|ref|, the new state within one storage ulp of the
    plain version's (where fp32 products round apart), finite, f8 saturated
    to +-448.  Returns the largest absolute error of y."""
    import torch

    from zonos_tpu_torch.kernels.ssm_state import (
        fused_state_step,
        fused_state_step_plain,
        storage_ulp,
    )

    worst = 0.0
    shapes = ((128, SSM_P, SSM_N), (1024, SSM_P, SSM_N)) + STATE_STEP_EXTRA_SHAPES
    for BH, P, N in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            state, C, B, dA, xdt = state_step_inputs(gen, BH, dtype, P, N)
            ref_state = state.clone()
            ref_bc, bc = (torch.empty(BH, device="cuda") for _ in range(2))
            ref_y, _ = fused_state_step_plain(ref_state, C, B, dA, xdt, bc=ref_bc)
            y, _ = fused_state_step(state, C, B, dA, xdt, bc=bc)
            torch.cuda.synchronize()
            err = float((y - ref_y).abs().max())
            if not err <= 1e-5 * float(ref_y.abs().max()):
                fail(f"fused_state_step BH={BH} {dtype}: y max abs err {err}")
            bc_err = float((bc - ref_bc).abs().max())
            if not bc_err <= 1e-5 * float(ref_bc.abs().max()):
                fail(f"fused_state_step BH={BH} {dtype}: B.C max abs err {bc_err}")
            diff = (state.float() - ref_state.float()).abs()
            if not bool((diff <= storage_ulp(ref_state)).all()) or not bool(
                    torch.isfinite(state.float()).all()):
                fail(f"fused_state_step BH={BH} {dtype}: state off by more than one ulp "
                     f"(max {float(diff.max())}) or not finite")
            if dtype == torch.float8_e4m3fn and float(state.float()[0, 0].abs().max()) != 448.0:
                fail(f"fused_state_step BH={BH} f8: a value past the range stored as "
                     f"{float(state.float()[0, 0].abs().max())}, not +-448")
            worst = max(worst, err)
            print(f"[kernels] K7 ok at [{BH},{P},{N}], {str(dtype).split('.')[-1]}: y max abs err "
                  f"{err:.3g}, B.C {bc_err:.3g}; {int((diff == 0).sum())}/{diff.numel()} stored "
                  f"values equal to the plain version's, the rest within one ulp", flush=True)
    return worst


def quant_state_inputs(gen, BH: int, mode: str, P: int = SSM_P, N: int = SSM_N) -> tuple:
    """An int8 or int4 state and its scales [BH] (from fp32 states whose heads
    span four orders of magnitude, quantized by the plain store), and fp32 C,
    B, dA, xdt."""
    import torch

    from zonos_tpu_torch.kernels.ssm_state import quantize_state

    spread = 10.0 ** (torch.rand((BH, 1, 1), generator=gen, device="cuda") * 4 - 2)
    q, scale = quantize_state(torch.randn((BH, P, N), generator=gen, device="cuda") * spread,
                              mode)
    C, B = (torch.randn((BH, N), generator=gen, device="cuda") for _ in range(2))
    dA = torch.rand((BH, 1), generator=gen, device="cuda") * 0.5 + 0.5
    xdt = torch.randn((BH, P), generator=gen, device="cuda") * spread[:, :, 0]
    return q.contiguous(), C, B, dA, xdt, scale.reshape(BH).contiguous()


def check_fused_state_step_quant(gen) -> dict:
    """``[kernels] K7 int8`` / ``K7 int4``: the kernel against its plain
    version at [128,64,128] (batch 1 with CFG) and [1024,64,128] (batch 8
    with CFG): y and B.C within 1e-5 x max|ref|, each scale within one fp32 ulp, each
    stored value within one grid step and at most 1e-3 of them apart (a .5
    boundary can round apart where the fp32 update differs by an ulp); and
    the 64 heads of one backbone row launched alone equal to the same heads
    inside the batch of 16 rows, bit for bit.  Returns each mode's largest
    absolute error of y."""
    import torch

    from zonos_tpu_torch.kernels.ssm_state import (
        dequantize_state,
        fused_state_step,
        fused_state_step_plain,
    )

    worst = {}
    for mode in ("int8", "int4"):
        worst[mode] = 0.0
        for BH in (128, 1024):
            q, C, B, dA, xdt, scale = quant_state_inputs(gen, BH, mode)
            ref_q, ref_scale = q.clone(), scale.clone()
            ref_bc, bc = (torch.empty(BH, device="cuda") for _ in range(2))
            ref_y, _ = fused_state_step_plain(ref_q, C, B, dA, xdt, ref_scale, bc=ref_bc)
            y, _ = fused_state_step(q, C, B, dA, xdt, scale, bc=bc)
            torch.cuda.synchronize()
            err = float((y - ref_y).abs().max())
            if not err <= 1e-5 * float(ref_y.abs().max()):
                fail(f"K7 {mode} BH={BH}: y max abs err {err}")
            if not float((bc - ref_bc).abs().max()) <= 1e-5 * float(ref_bc.abs().max()):
                fail(f"K7 {mode} BH={BH}: B.C max abs err {float((bc - ref_bc).abs().max())}")
            ulp = torch.nextafter(ref_scale, torch.full_like(ref_scale, float("inf"))) - ref_scale
            if not bool(((scale - ref_scale).abs() <= ulp).all()):
                fail(f"K7 {mode} BH={BH}: a scale off by more than one fp32 ulp")
            got = dequantize_state(q, scale.view(-1, 1, 1), mode)
            want = dequantize_state(ref_q, ref_scale.view(-1, 1, 1), mode)
            if not bool(((got - want).abs() <= ref_scale.view(-1, 1, 1) * 1.00001).all()):
                fail(f"K7 {mode} BH={BH}: a stored value off by more than one grid step")
            apart = float((q != ref_q).float().mean())
            if not apart <= 1e-3:
                fail(f"K7 {mode} BH={BH}: {apart:.3g} of the stored bytes differ (at most 1e-3)")
            worst[mode] = max(worst[mode], err)
            print(f"[kernels] K7 {mode} ok at [{BH},{SSM_P},{SSM_N}]: y max abs err {err:.3g} "
                  f"(tolerance 1e-5 x {float(ref_y.abs().max()):.3g}); "
                  f"{int((scale == ref_scale).sum())}/{BH} scales equal, the rest within one ulp; "
                  f"share of stored bytes apart from the plain version's {apart:.3g} (at most "
                  f"1e-3), each within one grid step", flush=True)
        # one backbone row's 64 heads alone and inside batch 8 with CFG (16 rows)
        q, C, B, dA, xdt, scale = quant_state_inputs(gen, 1024, mode)
        row = slice(3 * SSM_H, 4 * SSM_H)
        alone = [t[row].clone() for t in (q, C, B, dA, xdt, scale)]
        bc_all, bc_one = torch.empty(q.shape[0], device="cuda"), torch.empty(SSM_H, device="cuda")
        y_all, _ = fused_state_step(q, C, B, dA, xdt, scale, bc=bc_all)
        y_one, _ = fused_state_step(*alone, bc=bc_one)
        torch.cuda.synchronize()
        if not (torch.equal(y_one, y_all[row]) and torch.equal(alone[0], q[row])
                and torch.equal(alone[5], scale[row]) and torch.equal(bc_one, bc_all[row])):
            fail(f"K7 {mode}: a row alone differs from the same row inside batch 8")
        print(f"[kernels] K7 {mode}: a row's 64 heads alone equal the same heads inside batch 8 "
              f"(16 rows) bit for bit (y, B.C, stored bytes, scales)", flush=True)
    return worst


def quantized_cache(gen, storage: str, B: int, Hkv: int = 4, S: int = 2048) -> tuple:
    """k, v [B, Hkv, S, 128] in ``storage`` ("f8" or "int8") and, for int8,
    their fp32 row scales (else None), from normal rows of scale 2."""
    import torch

    from zonos_tpu_torch.models.backbone import quantize_kv_rows

    rows = [torch.randn((B, Hkv, S, 128), generator=gen, device="cuda") * 2 for _ in range(2)]
    if storage == "int8":
        (k, ks), (v, vs) = (quantize_kv_rows(r) for r in rows)
        return k, v, ks, vs
    return rows[0].to(torch.float8_e4m3fn), rows[1].to(torch.float8_e4m3fn), None, None


def held_out_inputs(gen, B: int, H: int = 16, Hkv: int = 4) -> tuple:
    """q [B,1,H,128] and the held-out k_new/v_new [B,1,Hkv,128], bf16."""
    import torch

    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((B, 1, H, 128), (B, 1, Hkv, 128), (B, 1, Hkv, 128)))


def check_decode_attention_quantized(gen) -> dict:
    """K1/K2 over f8 and int8 caches with the current row held out, against
    the plain split version (JAX's decode_attention_split math) fed fp32 q and
    held-out rows, at B in (2, 8) and lengths 1, 255, 256, 257, 2000 (pos =
    length - 1 cache rows plus the held-out one).  Tolerance: 4 bf16 ulps of
    max|ref| for f8 (the plain version reads an f8 cache's softmax weights and
    values in bf16, as JAX does, where the kernels keep fp32), 2 for int8
    (fp32 throughout; the kernels round their output once)."""
    import torch

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_single_held_out,
        decode_attention_split_plain,
        flash_decode_attention_held_out,
    )

    worst = {}
    for storage in ("f8", "int8"):
        for B in (2, 8):
            k, v, ks, vs = quantized_cache(gen, storage, B)
            q, k_new, v_new = held_out_inputs(gen, B)
            for length in (1, 255, 256, 257, 2000):
                pos = length - 1
                ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(),
                                                   pos, ks, vs)
                tol = (4 if storage == "f8" else 2) * bf16_ulp(float(ref.abs().max()))
                pos_t, band = on_card(pos, held_out=True)
                for name, fn in (("flash_decode_attention", flash_decode_attention_held_out),
                                 ("decode_attention_single", decode_attention_single_held_out)):
                    got = fn(q, k, v, k_new, v_new, pos_t, ks, vs, band=band)
                    torch.cuda.synchronize()
                    err = float((got.float() - ref).abs().max())
                    if not err <= tol:
                        fail(f"{name}_{storage} B={B} length={length}: max abs err {err} > {tol}")
                    key = f"{name}_{storage}"
                    worst[key] = max(worst.get(key, 0.0), err)
    print(f"[kernels] K1/K2 over f8 and int8 caches, held-out row, ok at B in (2, 8), lengths "
          f"(1, 255, 256, 257, 2000): max abs err {worst} (tolerance 4 bf16 ulps for f8, 2 for "
          f"int8)", flush=True)
    S, Hkv = 512, 4
    for storage in ("f8", "int8"):
        key = f"decode_attention_single_{storage}"
        for B, G in itertools.product(K2_CHECK_BATCHES, K2_CHECK_GROUPS):
            k, v, ks, vs = quantized_cache(gen, storage, B, Hkv, S)
            q, k_new, v_new = held_out_inputs(gen, B, G * Hkv, Hkv)
            # pos = length - 1: pos 0 is the held-out row alone
            for length in K2_CHECK_LENGTHS:
                pos = length - 1
                ref = decode_attention_split_plain(q.float(), k, v, k_new.float(), v_new.float(),
                                                   pos, ks, vs)
                pos_t, band = on_card(pos, held_out=True)
                got = decode_attention_single_held_out(q, k, v, k_new, v_new, pos_t, ks, vs,
                                                       band=band)
                torch.cuda.synchronize()
                err = float((got.float() - ref).abs().max())
                tol = (4 if storage == "f8" else 2) * bf16_ulp(float(ref.abs().max()))
                if not err <= tol:
                    fail(f"{key} B={B} G={G} pos={pos}: max abs err {err} > {tol}")
                worst[key] = max(worst[key], err)
    print(f"[kernels] K2 over f8 and int8 caches ok at B in {K2_CHECK_BATCHES}, G in "
          f"{K2_CHECK_GROUPS}, pos = length - 1 for lengths {K2_CHECK_LENGTHS}, S={S}: max abs "
          f"err f8 {worst['decode_attention_single_f8']:.3g}, int8 "
          f"{worst['decode_attention_single_int8']:.3g}", flush=True)
    return worst


def check_attention_grids(gen) -> None:
    """K1 and K2 run by every grid their split allows (clusters of g CTAs,
    each running n / g ranks in turn, as larger batches launch them)
    against one CTA a rank, bit for bit, over bf16, f8 and int8 caches at
    batch 1 with CFG: the grid follows the batch, the bits of a row's output
    must not."""
    import torch

    from zonos_tpu_torch.kernels import decode_attention as da

    real, checked = da.grid_cap, 0
    try:
        for kernel, lengths, S in (("K2", (1, 65, 100, 200, 256), 256),
                                   ("K1", (257, 300, 1000, 2000), 2048)):
            single = da.decode_attention_single if kernel == "K2" else da.flash_decode_attention
            held = (da.decode_attention_single_held_out if kernel == "K2"
                    else da.flash_decode_attention_held_out)
            q, k_new, v_new = held_out_inputs(gen, 2)
            k, v = (torch.randn((2, 4, S, 128), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            caches = {"bf16": None, **{st: quantized_cache(gen, st, 2, 4, S)
                                       for st in ("f8", "int8")}}
            for length in lengths:
                for storage, cache in caches.items():
                    if cache is None:
                        call = lambda: single(q, k, v, *on_card(length))  # noqa: E731
                    else:
                        kq, vq, ks, vs = cache
                        pos, band = on_card(length - 1, held_out=True)
                        call = lambda: held(q, kq, vq, k_new, v_new, pos, ks, vs,  # noqa: E731
                                            band=band)
                    ref = None
                    for g in (16, 8, 4, 2, 1):
                        da.grid_cap = lambda *a, g=g: g
                        got = call()
                        torch.cuda.synchronize()
                        if ref is None:
                            ref = got
                        elif not torch.equal(got, ref):
                            fail(f"{kernel} {storage} length {length}: a grid of {g} CTAs a "
                                 f"pair gives other bits than one CTA a rank")
                        checked += 1
    finally:
        da.grid_cap = real
    print(f"[kernels] K1/K2 by every grid of their split (16, 8, 4, 2, 1 CTAs a pair) equal to "
          f"one CTA a rank bit for bit, {checked} launches over bf16, f8 and int8 caches",
          flush=True)


def int4_weight(gen, din: int, dout: int) -> dict:
    """A random N(0, 1/din) weight quantized to int4, groups of 128 rows."""
    import torch

    from zonos_tpu_torch.ops.quant import quantize_weight_int4

    return quantize_weight_int4(torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5)


def check_int4_matmul(gen) -> float:
    """K8 vs the plain version (the same bf16 products q * s; fp32 sums, TF32
    off) at M in (1, 2, 8, 16, 32, 64) (each of the kernel's n-tile counts and
    their edges) for every weight it takes on the main paths: the flagship
    transformer's four layer weights and the heads, and the hybrid's in_proj
    and out_proj; groups of 128; tolerance 1e-5 x max|ref| (only the fp32
    summation order differs: the tensor cores' sums of 16 products, then
    fp32 adds).  Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain

    worst, by_weight = 0.0, {}
    for name, (din, dout) in {**FLAGSHIP_WEIGHTS, **HYBRID_WEIGHTS}.items():
        w = int4_weight(gen, din, dout)
        for M in INT4_CHECK_ROWS:
            x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
            ref = int4_matmul_plain(x, w["q4"], w["s4"])
            got = int4_matmul(x, w["q4"], w["s4"])
            torch.cuda.synchronize()
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            if not err <= 1e-5 * top:
                fail(f"int4_matmul {name} [{din},{dout}] M={M}: max abs err {err} > 1e-5 x {top}")
            worst = max(worst, err)
            by_weight[name] = max(by_weight.get(name, 0.0), err / top)
    print(f"[kernels] K8 ok at M in {INT4_CHECK_ROWS}, gs 128: max abs err {worst:.3g}; "
          f"worst / max|ref| by weight " + ", ".join(
              f"{n} {r:.3g}" for n, r in by_weight.items()) + " (tolerance 1e-5)", flush=True)
    return worst


def layer_tail_args(gen, B2: int, d: int = 2048, inter: int = 8192) -> tuple:
    """K4's operands at the flagship widths: bf16 attention output and
    residual, int8 wo/w1/w2 quantized from N(0, 1/fan_in), LayerNorm scale
    near 1 and bias near 0."""
    import torch

    from zonos_tpu_torch.ops.quant import quantize_weight_int8

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    wo = quantize_weight_int8(rnd(d, d, scale=d ** -0.5))
    w1 = quantize_weight_int8(rnd(d, 2 * inter, scale=d ** -0.5))
    w2 = quantize_weight_int8(rnd(inter, d, scale=inter ** -0.5))
    return (rnd(B2, d).bfloat16(), rnd(B2, d).bfloat16(), wo["q"], wo["s"],
            (1 + rnd(d, scale=0.1)).bfloat16(), rnd(d, scale=0.1).bfloat16(),
            w1["q"], w1["s"], w2["q"], w2["s"])


def check_layer_tail(gen) -> float:
    """K4 vs the plain version at B2 in (1, 2, 8, 64, 128), flagship widths.
    Tolerance 1e-2 x max|ref|, half the JAX test's fused-vs-unfused bound
    (tests/test_pallas_decode.py:46): the fp32 sums run in another order, which
    can move the bf16 roundings of h, the activation and the output by an
    ulp.  Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail, fused_layer_tail_plain

    worst = worst_rel = 0.0
    for B2 in LAYER_TAIL_CHECK_ROWS:
        args = layer_tail_args(gen, B2)
        ref = fused_layer_tail_plain(*args).float()
        got = fused_layer_tail(*args).float()
        torch.cuda.synchronize()
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        if not err <= 1e-2 * top or not bool(torch.isfinite(got).all()):
            fail(f"fused_layer_tail B2={B2}: max abs err {err} > 1e-2 x {top}")
        worst, worst_rel = max(worst, err), max(worst_rel, err / top)
        print(f"[kernels] K4 ok at B2={B2}: max abs err {err:.3g}, "
              f"{int((got == ref).sum())}/{ref.numel()} outputs equal to the plain version's",
              flush=True)
    print(f"[kernels] K4 worst / max|ref| {worst_rel:.3g} (tolerance 1e-2)", flush=True)
    return worst


def _pair_in_batch(fn, one, rows: int, gen) -> bool:
    """fn on the operand ``one`` (its first axis: a request's rows) against
    fn on ``rows`` random rows with ``one`` placed first: the request's part
    of the output the same bits?"""
    import torch

    big = torch.randn((rows,) + tuple(one.shape[1:]), generator=gen, device="cuda").to(one.dtype)
    big[:one.shape[0]] = one
    ref, got = fn(one), fn(big)[:one.shape[0]]
    torch.cuda.synchronize()
    return torch.equal(ref, got)


def check_gemm(gen) -> float:
    """G1 vs its plain version (fp32 sums of the bf16 products rounded once;
    int8: then times the bf16 scales) at M in GEMM_CHECK_ROWS (one and two
    consumer warpgroups, cluster and in-CTA splits, ragged edges) for every
    weight ``matmul_w`` gives it on the main paths: the flagship
    transformer's four layer weights and the heads, the hybrid's in_proj
    (8512 columns: a ragged last tile) and out_proj, in bf16 and int8.
    Tolerance: 1 bf16 ulp of max|ref| (only the fp32 summation order differs
    before the one rounding).  Then the probe of the design's choices by M:
    at GEMM_PROBE_ROWS, every row tile (64 or 128 rows a CTA) with the splits
    as a cluster's CTAs or in turn in one CTA gives the same bits as the
    plan's launch; a request's rows alone the same bits as first in a batch
    (2 rows in 128, 142 in 64 x 142) and as rows 70-71 of 142 (another place
    in the tile); and every cluster size 1-8 (K = 256 n) against the plain
    version and the in-CTA splits.  Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.gemm import GemmPlan, gemm, gemm_plain, gemm_plan
    from zonos_tpu_torch.kernels._build import sm_count
    from zonos_tpu_torch.ops.quant import quantize_weight_int8

    sms = sm_count(torch.cuda.current_device())
    worst, by_weight, probes = 0.0, {}, 0
    for name, (din, dout) in {**FLAGSHIP_WEIGHTS, **HYBRID_WEIGHTS}.items():
        wf = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
        for kind, args in (("bf16", (wf.bfloat16(),)),
                           ("int8", tuple(quantize_weight_int8(wf).values()))):
            for M in GEMM_CHECK_ROWS:
                x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
                ref = gemm_plain(x, *args).float()
                got = gemm(x, *args)
                if M in GEMM_PROBE_ROWS:
                    plan = gemm_plan(M, din, dout, sms)
                    for bm in (64, 128):
                        for parallel in (False, True):
                            other = gemm(x, *args, plan=GemmPlan(plan.n_split,
                                                                 plan.rows_per_split, bm,
                                                                 parallel))
                            probes += 1
                            if not torch.equal(other, got):
                                fail(f"gemm {name} {kind} M={M}: the plan's launch {plan} and "
                                     f"bm={bm} parallel={parallel} give other bits")
                torch.cuda.synchronize()
                got = got.float()
                err, top = float((got - ref).abs().max()), float(ref.abs().max())
                if not err <= bf16_ulp(top) or not bool(torch.isfinite(got).all()):
                    fail(f"gemm {name} {kind} [{din},{dout}] M={M}: max abs err {err} > 1 bf16 "
                         f"ulp of {top}")
                worst = max(worst, err)
                by_weight[f"{name} {kind}"] = max(by_weight.get(f"{name} {kind}", 0.0),
                                                  err / bf16_ulp(top))
            for rows, big in ((2, 128), (142, 64 * 142)):
                one = torch.randn((rows, din), generator=gen, device="cuda").bfloat16()
                if not _pair_in_batch(lambda x: gemm(x, *args), one, big, gen):
                    fail(f"gemm {name} {kind}: {rows} rows alone and first in {big} differ")
            x = torch.randn((142, din), generator=gen, device="cuda").bfloat16()
            if not torch.equal(gemm(x[70:72].contiguous(), *args), gemm(x, *args)[70:72]):
                fail(f"gemm {name} {kind}: rows 70-71 alone and in 142 rows differ")
    for n in range(1, 9):
        K = 256 * n
        w = (torch.randn((K, 256), generator=gen, device="cuda") / K ** 0.5).bfloat16()
        for M in (2, 100):
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            ref = gemm_plain(x, w).float()
            outs = [gemm(x, w, plan=GemmPlan(n, 256, bm, parallel))
                    for bm in (64, 128) for parallel in (True, False)]
            torch.cuda.synchronize()
            err, top = float((outs[0].float() - ref).abs().max()), float(ref.abs().max())
            if not err <= bf16_ulp(top) or not all(torch.equal(o, outs[0]) for o in outs):
                fail(f"gemm with a cluster of {n} at M={M}: max abs err {err} (1 bf16 ulp of "
                     f"{top}) or the tile choices' bits differ")
    print(f"[kernels] G1 ok at M in {GEMM_CHECK_ROWS}: max abs err {worst:.3g}; worst in bf16 "
          f"ulps of max|ref| by weight " + ", ".join(f"{n} {r:.2g}" for n, r in by_weight.items())
          + f" (tolerance 1); the tile-choice probe at M in {GEMM_PROBE_ROWS}: {probes} launches "
          "(64- and 128-row tiles, cluster and in-CTA splits) the same bits as the plan's; 2 rows "
          "alone = first in 128, 142 alone = first in 9088, rows 70-71 alone = in 142, bit for "
          "bit; clusters of 1-8 CTAs within 1 ulp and equal to the in-CTA splits",
          flush=True)
    return worst


def check_row_norm(gen) -> float:
    """N1 vs its plain versions: LayerNorm and RMSNorm (with and without
    bias) of bf16 and fp32 rows of the flagship widths (d 2048, and the
    hybrid mixer's 4096) at 1, 2, 8, 128 and 9088 rows.  Tolerance: 2 ulps of
    max|ref| in the output dtype (bf16, or fp32 as 2^-22 of it): only the
    fp32 statistics' summation order differs.  Then 2 rows alone against
    first in 128, bit for bit.  Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.row_norm import (
        layer_norm,
        layer_norm_plain,
        rms_norm,
        rms_norm_plain,
    )

    worst = 0.0
    for d in (2048, 4096):
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        cases = (("layer", lambda x: layer_norm(x, scale, bias),
                  lambda x: layer_norm_plain(x, scale, bias)),
                 ("rms", lambda x: rms_norm(x, scale), lambda x: rms_norm_plain(x, scale)),
                 ("rms+bias", lambda x: rms_norm(x, scale, bias=bias),
                  lambda x: rms_norm_plain(x, scale, bias=bias)))
        for dtype in (torch.bfloat16, torch.float32):
            for name, fn, plain in cases:
                for rows in (1, 2, 8, 128, 9088):
                    x = (3 + 2 * torch.randn((rows, d), generator=gen, device="cuda")).to(dtype)
                    ref, got = plain(x).float(), fn(x).float()
                    torch.cuda.synchronize()
                    err, top = float((got - ref).abs().max()), float(ref.abs().max())
                    ulp = bf16_ulp(top) if dtype == torch.bfloat16 else top * 2.0 ** -22
                    if not err <= 2 * ulp:
                        fail(f"row_norm {name} {dtype} d={d} rows={rows}: max abs err {err} > 2 "
                             f"ulps of {top}")
                    worst = max(worst, err)
                one = (3 + 2 * torch.randn((2, d), generator=gen, device="cuda")).to(dtype)
                if not _pair_in_batch(fn, one, 128, gen):
                    fail(f"row_norm {name} {dtype} d={d}: 2 rows alone and first in 128 differ")
    print(f"[kernels] N1 ok (LayerNorm, RMSNorm, RMSNorm + bias; bf16 and fp32 rows of 2048 and "
          f"4096 at 1-9088 rows): max abs err {worst:.3g} (tolerance 2 ulps of max|ref|); 2 rows "
          f"alone = first in 128, bit for bit", flush=True)
    return worst


def _norms(gen, d: int) -> tuple:
    """(name, Norm) of a LayerNorm with bias and an RMSNorm without, random
    bf16 parameters of width d (the transformer's norms and the hybrid's)."""
    import torch

    from zonos_tpu_torch.kernels.row_norm import Norm

    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    return (("LayerNorm", Norm(scale, bias, 1e-5, False)),
            ("RMSNorm", Norm(scale, None, 1e-5, True)))


def _n1(x, norm):
    """N1 alone: the unfused route's norm, in x's dtype."""
    from zonos_tpu_torch.kernels import row_norm as n1

    if norm.rms:
        return n1.rms_norm(x, norm.scale, norm.eps, norm.bias)
    return n1.layer_norm(x, norm.scale, norm.bias, norm.eps)


def _residual(gen, M: int, d: int, dtype):
    """Rows like a residual stream: an offset mean and a spread, in dtype."""
    import torch

    return (3 + 2 * torch.randn((M, d), generator=gen, device="cuda")).to(dtype)


def check_gemm_fold(gen) -> float:
    """G1 with a folded norm (``gemm(x, w, norm=)``) against N1 and then G1
    (x normalised, rounded to bf16, then the product: the unfused route)
    bit for bit; against the plain product of N1's x within G1's tolerance,
    1 bf16 ulp of max|ref| (int8: 2, since its output is rounded twice, the
    sum and then the sum times the column's scale, so one ulp of the sum
    can become two of the output); and against the plain composition (the
    plain norm, the cast, the plain product) within one ulp more (the plain
    norm may round an element of x an ulp away from N1, N1's own tolerance
    being 2 ulps of its output), at M in GEMM_CHECK_ROWS on every weight a
    norm feeds (NORM_FED_WEIGHTS), bf16 and int8, LayerNorm and RMSNorm,
    bf16 and fp32 x (the hybrid's residual; up to 16 rows, what G1 folds).
    At GEMM_PROBE_ROWS every tile choice (64- or 128-row tiles, cluster or
    in-CTA splits) gives the plan's bits; 2 rows alone give the same bits as
    first in 128 (fp32 x: 16).  Returns the largest absolute error against
    the plain composition."""
    import torch

    from zonos_tpu_torch.kernels._build import sm_count
    from zonos_tpu_torch.kernels.gemm import F32_MAX_ROWS, GemmPlan, gemm, gemm_plain, gemm_plan
    from zonos_tpu_torch.kernels.row_norm import norm_plain
    from zonos_tpu_torch.ops.quant import quantize_weight_int8

    sms = sm_count(torch.cuda.current_device())
    weights = {**FLAGSHIP_WEIGHTS, **HYBRID_WEIGHTS}
    worst, probes, cases = 0.0, 0, 0
    for name in NORM_FED_WEIGHTS:
        din, dout = weights[name]
        wf = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
        for kind, args in (("bf16", (wf.bfloat16(),)),
                           ("int8", tuple(quantize_weight_int8(wf).values()))):
            for norm_name, norm in _norms(gen, din):
                for dtype in (torch.bfloat16, torch.float32):
                    tag = f"gemm_norm {name} {kind} {norm_name} x {dtype}"
                    for M in GEMM_CHECK_ROWS:
                        if dtype == torch.float32 and M > F32_MAX_ROWS:
                            continue  # fp32 x is folded up to 16 rows
                        x = _residual(gen, M, din, dtype)
                        got = gemm(x, *args, norm=norm)
                        h = _n1(x, norm).bfloat16()
                        if not torch.equal(got, gemm(h, *args)):
                            fail(f"{tag} M={M}: the folded norm and N1 then G1 differ")
                        if M in GEMM_PROBE_ROWS:
                            plan = gemm_plan(M, din, dout, sms)
                            for bm in (64, 128):
                                for parallel in (False, True):
                                    other = gemm(x, *args, norm=norm, plan=GemmPlan(
                                        plan.n_split, plan.rows_per_split, bm, parallel))
                                    probes += 1
                                    if not torch.equal(other, got):
                                        fail(f"{tag} M={M}: bm={bm} parallel={parallel} give "
                                             f"other bits than the plan's {plan}")
                        ref = gemm_plain(norm_plain(x, norm).bfloat16(), *args).float()
                        ref1 = gemm_plain(h, *args).float()
                        torch.cuda.synchronize()
                        err, top = float((got.float() - ref).abs().max()), float(ref.abs().max())
                        err1 = float((got.float() - ref1).abs().max())
                        ulps = 1 if kind == "bf16" else 2
                        if (not err1 <= ulps * bf16_ulp(float(ref1.abs().max()))
                                or not err <= (ulps + 1) * bf16_ulp(top)
                                or not bool(torch.isfinite(got).all())):
                            fail(f"{tag} M={M}: max abs err {err1} against the plain product of "
                                 f"N1's x ({ulps} bf16 ulps), {err} against the plain "
                                 f"composition ({ulps + 1} ulps of {top})")
                        worst = max(worst, err)
                        cases += 1
                    one = _residual(gen, 2, din, dtype)
                    big = 128 if dtype == torch.bfloat16 else F32_MAX_ROWS
                    if not _pair_in_batch(lambda t: gemm(t, *args, norm=norm), one, big, gen):
                        fail(f"{tag}: 2 rows alone and first in {big} differ")
    print(f"[kernels] G1 with a folded norm ok: {cases} cases ({', '.join(NORM_FED_WEIGHTS)}; "
          f"bf16 and int8; LayerNorm and RMSNorm; bf16 and fp32 x; M in {GEMM_CHECK_ROWS}, fp32 "
          f"up to {F32_MAX_ROWS}) the "
          f"same bits as N1 then G1, within 1 bf16 ulp of max|ref| (int8: 2) of the plain "
          f"product of N1's x, max abs err {worst:.3g} against the plain composition "
          f"(tolerance one ulp more); {probes} tile-choice launches at M in "
          f"{GEMM_PROBE_ROWS} the plan's bits; 2 rows alone = first in 128 (fp32 x: 16)",
          flush=True)
    return worst


def check_int4_fold(gen) -> float:
    """K8 with a folded norm against N1 and then K8 bit for bit; against
    K8's plain version on N1's x within K8's 1e-5 x max|ref|; and against
    the plain composition (the plain norm, the cast, the plain K8) within 2
    bf16 ulps of max|ref| (the output is cast to bf16 after K8; N1 and the
    plain norm may round an x element one bf16 ulp apart), at INT4_FOLD_ROWS on NORM_FED_WEIGHTS,
    LayerNorm and RMSNorm, bf16 and fp32 x; 2 rows alone the same bits as
    first in 16.  Returns the largest absolute error."""
    import torch

    from zonos_tpu_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain
    from zonos_tpu_torch.kernels.row_norm import norm_plain

    weights = {**FLAGSHIP_WEIGHTS, **HYBRID_WEIGHTS}
    worst, cases = 0.0, 0
    for name in NORM_FED_WEIGHTS:
        din, dout = weights[name]
        w = int4_weight(gen, din, dout)
        q, s4 = w["q4"], w["s4"]
        for norm_name, norm in _norms(gen, din):
            for dtype in (torch.bfloat16, torch.float32):
                tag = f"int4_matmul_norm {name} {norm_name} x {dtype}"
                for M in INT4_FOLD_ROWS:
                    x = _residual(gen, M, din, dtype)
                    got = int4_matmul(x, q, s4, norm=norm)
                    h = _n1(x, norm).bfloat16()
                    if not torch.equal(got, int4_matmul(h, q, s4)):
                        fail(f"{tag} M={M}: the folded norm and N1 then K8 differ")
                    ref = int4_matmul_plain(norm_plain(x, norm).bfloat16(), q, s4)
                    ref1 = int4_matmul_plain(h, q, s4)
                    torch.cuda.synchronize()
                    err, top = float((got - ref).abs().max()), float(ref.abs().max())
                    err1 = float((got - ref1).abs().max())
                    if not err1 <= 1e-5 * float(ref1.abs().max()) or not err <= 2 * bf16_ulp(
                            top) or not bool(torch.isfinite(got).all()):
                        fail(f"{tag} M={M}: max abs err {err1} against the plain K8 of N1's x "
                             f"(1e-5 x max|ref|), {err} against the plain composition (2 bf16 "
                             f"ulps of {top})")
                    worst = max(worst, err)
                    cases += 1
                one = _residual(gen, 2, din, dtype)
                if not _pair_in_batch(lambda t: int4_matmul(t, q, s4, norm=norm), one, 16, gen):
                    fail(f"{tag}: 2 rows alone and first in 16 differ")
    print(f"[kernels] K8 with a folded norm ok: {cases} cases ({', '.join(NORM_FED_WEIGHTS)}; "
          f"LayerNorm and RMSNorm; bf16 and fp32 x; M in {INT4_FOLD_ROWS}) the same bits as N1 "
          f"then K8, within 1e-5 x max|ref| of the plain K8 of N1's x, max abs err {worst:.3g} "
          f"against the plain composition (tolerance 2 bf16 ulps of max|ref|); 2 rows alone = "
          f"first in 16", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


def load_model(kind: str):
    """The full-width flagship ``kind`` ("transformer" or "hybrid"), random bf16
    weights from seed 0, on the card."""
    import torch

    from zonos_tpu_torch import Zonos, ZonosConfig
    from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT

    t0 = time.perf_counter()
    cfg = TRANSFORMER_CONFIG_DICT if kind == "transformer" else HYBRID_CONFIG_DICT
    model = Zonos(ZonosConfig.from_dict(cfg), seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    print(f"[main {kind}] flagship {kind} ({n_params / 1e9:.3f} B params, bf16, "
          f"{model.config.backbone.n_layer} layers) initialised in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return model


def quantize_model(kind: str, model, mode: str) -> None:
    """``model.quantize_int8()`` or ``quantize_int4()`` in place, timed."""
    import torch

    t0 = time.perf_counter()
    getattr(model, f"quantize_{mode}")()
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(model.params))
    print(f"[main {kind} {mode}] quantized in {time.perf_counter() - t0:.1f} s: "
          f"{nbytes / 1e9:.3f} GB of parameters", flush=True)


def check_replayed(tag: str, stats: dict) -> None:
    """A generate on the card ran its decode steps as CUDA-graph replays: at
    least one graph captured, and every step after the eager first one a
    replay."""
    if not stats or stats["graphs"] < 1:
        fail(f"{tag}: generate captured no CUDA graph ({stats})")
    print(f"{tag} decode: {stats['steps']} steps, {stats['graphs']} CUDA graphs captured in "
          f"{stats['capture_s'] * 1e3:.1f} ms, every step after the first a replay", flush=True)


def phase_graph(card: str, kind: str, model, prefix, new_tokens: int) -> dict:
    """``[graph kind]``: the private eager decode loop and the CUDA graphs on
    one batch-1 generate with the same seed (default sampling, EOS banned so
    that every run reaches the same bands): the codes must be equal bit for
    bit.  Prints the wall ms per decode step of each, the capture time and
    the graphs captured."""
    import numpy as np
    import torch

    from zonos_tpu_torch.ops.sampling import SamplingParams

    tag = f"[graph {kind}]"
    sampling = SamplingParams(ban_eos=True)

    def run(graphs: bool):
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = model._generate(prefix, new_tokens, 2.0, 1, sampling, 7, None, graphs=graphs)
        torch.cuda.synchronize()
        return codes, time.perf_counter() - t, dict(model.decode_stats)

    eager, t_eager, st_eager = run(False)
    graph, t_graph, st_graph = run(True)
    if len(eager) != len(graph) or not all(a.shape == b.shape and np.array_equal(a, b)
                                           for a, b in zip(eager, graph)):
        fail(f"{tag}: the CUDA graphs' codes differ from the eager loop's")
    check_replayed(tag, st_graph)
    steps = st_graph["steps"]
    out = {"steps": steps, "eager_ms": t_eager * 1e3 / steps, "graph_ms": t_graph * 1e3 / steps,
           "graph_ms_without_capture": (t_graph - st_graph["capture_s"]) * 1e3 / steps,
           "capture_ms": st_graph["capture_s"] * 1e3, "graphs": st_graph["graphs"]}
    print(f"{tag} batch 1, {new_tokens} new tokens ({steps} decode steps + prefill): codes of "
          f"the eager loop and the graphs equal bit for bit ({eager[0].shape[1]} frames); wall "
          f"ms/step eager {out['eager_ms']:.2f}, graphs {out['graph_ms']:.2f} "
          f"({out['graph_ms_without_capture']:.2f} without the capture); {out['graphs']} graphs "
          f"captured in {out['capture_ms']:.1f} ms ({card})", flush=True)
    return out


def phase_main_path(card: str, kind: str, model, dac, batch: int, expect: tuple,
                    new_tokens: int = MAX_NEW_TOKENS, batch_kv: str | None = None,
                    forbid: tuple = ()):
    """Batch 1 twice (same seed: identical codes) and batch ``batch`` once
    (with the KV cache in ``batch_kv`` storage), the DAC decode and the wav
    saves, with the launch counts zeroed just before and read just after;
    every kernel in ``expect`` must have launched, none in ``forbid``."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = f"[main {kind}]"

    def generate(prefix, rows, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = model.generate(prefix, max_new_tokens=new_tokens, batch_size=rows, seed=seed,
                               progress_bar=False)
        torch.cuda.synchronize()
        check_replayed(tag, model.decode_stats)
        return codes, time.perf_counter() - t

    def check_codes(codes, rows):
        if len(codes) != rows:
            fail(f"generate returned {len(codes)} samples, expected {rows}")
        for c in codes:
            if c.ndim != 2 or c.shape[0] != 9 or not 1 <= c.shape[1] <= new_tokens:
                fail(f"codes of shape {c.shape}, expected [9, 1..{new_tokens}]")
            if c.min() < 0 or c.max() >= 1024:
                fail(f"codes outside [0, 1024): {c.min()}..{c.max()}")

    # record the SSM-state storage (hybrid) or KV storage (transformer) of every
    # cache the path makes
    ssm_dtypes, kv_dtypes = {}, {}
    make_cache = model.backbone.make_cache

    def recording_make_cache(cfg, rows, *args, **kwargs):
        cache = make_cache(cfg, rows, *args, **kwargs)
        if isinstance(cache, list):
            ssm_dtypes[rows] = {st["ssm"].dtype for st in cache if "ssm" in st}
        else:
            kv_dtypes[rows] = cache.k.dtype
        return cache

    model.backbone = dataclasses.replace(model.backbone, make_cache=recording_make_cache)

    reset_launch_counts()
    prefix1 = model.prepare_conditioning(make_cond_dict(text=TEXTS[0], speaker=None))
    codes1, dt1 = generate(prefix1, 1, 7)
    codes1b, dt1b = generate(prefix1, 1, 7)
    check_codes(codes1, 1)
    if codes1[0].shape != codes1b[0].shape or not np.array_equal(codes1[0], codes1b[0]):
        fail(f"{kind}: batch-1 generate with the same seed gave different codes")
    prefixn = model.prepare_conditioning(make_cond_dict(text=TEXTS[:batch], speaker=None))
    model.set_storage(kv=batch_kv)
    codesn, dtn = generate(prefixn, batch, [11 + i for i in range(batch)])
    model.set_storage()
    check_codes(codesn, batch)

    torch.cuda.synchronize()
    t = time.perf_counter()
    wav = dac.decode(codes1[0][None])
    torch.cuda.synchronize()
    dt_dac = time.perf_counter() - t
    if wav.shape != (1, 1, codes1[0].shape[1] * 512) or not np.isfinite(wav).all():
        fail(f"DAC decode gave shape {wav.shape} or non-finite samples")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, "b1.wav")] + [os.path.join(tmp, f"b{batch}_{i}.wav")
                                                  for i in range(batch)]
        dac.save_codes(paths[:1], codes1)
        dac.save_codes(paths[1:], codesn)
        for path in paths:
            sr, data = wavfile.read(path)
            data = data.astype(np.float64) / 32767.0
            rms = float(np.sqrt((data**2).mean()))
            if sr != 44100 or not np.isfinite(data).all() or not rms > 0:
                fail(f"{os.path.basename(path)}: sr {sr}, rms {rms}")
    counts = dict(launch_counts)
    model.backbone = dataclasses.replace(model.backbone, make_cache=make_cache)
    if "ssd_chunked" in expect:  # K6's shapes: the batch-1 and batch-n prefills
        if (2 * batch, prefixn.shape[1] + 1) != K6_TIMED[2]:
            fail(f"{kind}: the batch-{batch} prefill is x [{2 * batch},{prefixn.shape[1] + 1},...],"
                 f" not K6_TIMED's {K6_TIMED[2]}")
        prefill_k6(tag, model, ((prefix1, 1), (prefixn, batch)), card)
    label_n = f"batch {batch}" + (f", {batch_kv} KV cache" if batch_kv else "")
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in expect:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {kind} path")
    for name in forbid:
        if counts[name] != 0:
            fail(f"kernel {name} was launched {counts[name]} times on the {kind} path")
    if kv_dtypes:
        print(f"{tag} KV cache storage by cache rows: "
              f"{ {rows: str(dt) for rows, dt in kv_dtypes.items()} }", flush=True)
        want = {None: torch.bfloat16, "f8": torch.float8_e4m3fn, "int8": torch.int8}[batch_kv]
        if kv_dtypes.get(2 * batch) != want or kv_dtypes.get(2) != torch.bfloat16:
            fail(f"{kind}: KV caches {kv_dtypes}, expected bf16 at batch 1 and {want} at "
                 f"batch {batch}")
    if ssm_dtypes:
        print(f"{tag} SSM state storage by cache rows: "
              f"{ {rows: sorted(str(d) for d in ds) for rows, ds in ssm_dtypes.items()} }",
              flush=True)
        if ssm_dtypes.get(2 * batch) != {torch.float8_e4m3fn}:
            fail(f"{kind}: batch {batch} ({2 * batch} rows) did not store the SSM state in f8")

    for label, codes, dt in (("batch 1", codes1, dt1), ("batch 1 again", codes1b, dt1b),
                             (label_n, codesn, dtn)):
        frames = sum(c.shape[1] for c in codes)
        steps = max(c.shape[1] for c in codes) + 8
        print(f"{tag} {label}: {frames} frames in {dt:.2f} s = {frames / dt:.1f} tokens/s "
              f"(frames of 9 codebooks), {dt * 1e3 / steps:.2f} ms per decode step, "
              f"real-time factor {frames / FRAMES_PER_S / dt:.2f} (generate only; {card})",
              flush=True)
    audio_s = codes1[0].shape[1] / FRAMES_PER_S
    print(f"{tag} DAC decode of {audio_s:.2f} s of audio in {dt_dac:.3f} s; wavs at 44100 Hz, "
          f"finite, nonzero RMS ({card})", flush=True)
    return counts, prefix1


def prefill_k6(tag: str, model, prefixes, card: str, audio_prefix_codes=None) -> None:
    """For each (prefix, batch): the prefill's wall (host clock around
    ``Zonos._prefill`` and a synchronise, median of 3) and, from one traced
    prefill (CUPTI), the device's busy time and K6's device time in it (one
    launch a Mamba layer), after ``audio_prefix_codes`` where given.  Run
    after the path's launch counts are read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    audio = 0 if audio_prefix_codes is None else audio_prefix_codes.shape[2]
    for prefix, batch in prefixes:
        def run():
            with torch.inference_mode():
                model._prefill(prefix, max_new_tokens=8, cfg_scale=2.0, batch_size=batch,
                               sampling_params=None, seed=[3 + i for i in range(batch)],
                               step_limits=None, audio_prefix_codes=audio_prefix_codes)
            torch.cuda.synchronize()

        run()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        k6 = [e for e in kernels if "ssd_chunked" in e.key]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        ms, n = sum(e.self_device_time_total for e in k6) / 1e3, sum(e.count for e in k6)
        print(f"{tag} prefill of {prefix.shape[1] + audio + 1} steps at batch {batch} ({2 * batch} rows): "
              f"wall {statistics.median(walls):.2f} ms, device busy {busy:.3f} ms, K6 {ms:.4f} ms "
              f"over {n} launches ({ms * 1e3 / max(n, 1):.2f} us a launch; CUPTI; {card})",
              flush=True)


def phase_hybrid_quantized(card: str, model, prefix, expect: tuple,
                           new_tokens: int = HYBRID_INT4_NEW_TOKENS) -> dict:
    """One batch-1 generate of the quantized hybrid with the launch counts
    zeroed just before and read just after; every kernel in ``expect`` must
    have launched."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = "[main hybrid int4]"
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    codes = model.generate(prefix, max_new_tokens=new_tokens, batch_size=1, seed=7,
                           progress_bar=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = dict(launch_counts)
    check_replayed(tag, model.decode_stats)
    c = codes[0]
    if len(codes) != 1 or c.shape[0] != 9 or not 1 <= c.shape[1] <= new_tokens or \
            c.min() < 0 or c.max() >= 1024:
        fail(f"hybrid int4: codes of shape {c.shape}, range {c.min()}..{c.max()}")
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in expect:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the hybrid int4 path")
    steps = c.shape[1] + 8
    print(f"{tag} batch 1: {c.shape[1]} frames in {dt:.2f} s, {dt * 1e3 / steps:.2f} ms per "
          f"decode step, real-time factor {c.shape[1] / FRAMES_PER_S / dt:.2f} ({card})",
          flush=True)
    return counts


def phase_encode(card: str, dac):
    """``[encode]``: a 3-s clip made from the seed (a tone and noise) written
    with ``save_audio`` at 24 kHz, read back by ``load_prefix_audio`` (mono,
    resampled to 44.1 kHz, left-padded, encoded: K5 on the encoder's residual
    units), twice: the same codes, [1, 9, 259], in range.  Prints each wall
    and K5's launches; returns (codes, the launch counts of the first)."""
    import numpy as np
    import torch

    from zonos_tpu_torch.audio import save_audio
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = "[encode]"
    rng = np.random.default_rng(1234)
    t = np.arange(ENCODE_SECONDS * ENCODE_RATE) / ENCODE_RATE
    clip = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
    walls, runs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prefix.wav")
        save_audio(path, clip[None], ENCODE_RATE)
        reset_launch_counts()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(dac.load_prefix_audio(path))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(runs) == 1:
                counts = dict(launch_counts)
    codes = runs[0]
    if codes.shape != (1, 9, ENCODE_FRAMES) or codes.min() < 0 or codes.max() >= 1024:
        fail(f"{tag} codes of shape {codes.shape}, range {codes.min()}..{codes.max()}")
    if not np.array_equal(codes, runs[1]):
        fail(f"{tag} encoding the clip twice gave different codes")
    if counts["snake_conv1d"] <= 0:
        fail(f"{tag} K5 was not launched by the encoder")
    print(f"{tag} {ENCODE_SECONDS} s at {ENCODE_RATE} Hz -> codes {tuple(codes.shape)}, twice "
          f"equal; wall {walls[0]:.3f} s the first time, {walls[1]:.3f} s the second (read, "
          f"resample, encode); K5 {counts['snake_conv1d']} launches an encode; "
          f"{len(np.unique(codes[0, 0]))} distinct codes in codebook 0 ({card})", flush=True)
    return codes, counts


def phase_prefix(card: str, kind: str, model, prefix, audio_codes, expect: tuple) -> dict:
    """``[prefix kind]``: ``generate(audio_prefix_codes=...)`` with the
    encoded clip at batch 1, twice with one seed (identical codes, the prefix
    cut off, the decode as graph replays), with the launch counts zeroed just
    before and read just after; on the hybrid also the longer prefill's wall
    and K6's device time."""
    import numpy as np
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = f"[prefix {kind}]"
    reset_launch_counts()
    outs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(model.generate(prefix, audio_prefix_codes=audio_codes,
                                   max_new_tokens=PREFIX_NEW_TOKENS, batch_size=1, seed=7,
                                   progress_bar=False)[0])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check_replayed(tag, model.decode_stats)
    counts = dict(launch_counts)
    a, b = outs
    if a.shape != b.shape or not np.array_equal(a, b):
        fail(f"{tag} two generates with one seed gave different codes")
    if a.shape[0] != 9 or not 1 <= a.shape[1] <= PREFIX_NEW_TOKENS or a.min() < 0 or \
            a.max() >= 1024:
        fail(f"{tag} codes of shape {a.shape} (the prefix of {audio_codes.shape[2]} frames is "
             f"cut off: at most {PREFIX_NEW_TOKENS} frames), range {a.min()}..{a.max()}")
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in expect:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {kind} prefix path")
    steps = model.decode_stats["steps"]
    print(f"{tag} batch 1 after a {audio_codes.shape[2]}-frame audio prefix and a "
          f"{prefix.shape[1]}-row conditioning: {a.shape[1]} new frames (the prefix cut off), "
          f"twice equal; wall {walls[0]:.2f} / {walls[1]:.2f} s, {walls[1] * 1e3 / steps:.2f} ms "
          f"per decode step ({steps} steps; {card})", flush=True)
    if "ssd_chunked" in expect:
        prefill_k6(tag, model, ((prefix, 1),), card, audio_prefix_codes=audio_codes)
    return counts


def phase_stream(card: str, model, dac) -> dict:
    """``[stream transformer]``: ``stream_generate`` at batch 1 and
    ``stream_generate_batch`` at batch 4, 260 new tokens, one seed each.  The
    streamed codes (the stream's decode state, read at its end through a spy
    on ``_prefill``) must equal ``generate``'s bit for bit, and each row's
    concatenated chunks must be within 1e-4 x max|full| of the DAC decode of
    its codes.  Prints the time to first audio and the chunks.  The launch
    counts are zeroed just before each stream and read just after it."""
    import numpy as np
    import torch

    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = "[stream transformer]"
    model._autoencoder = dac
    counts = {name: 0 for name in launch_counts}
    for rows in (1, STREAM_BATCH):
        prefix = model.prepare_conditioning(make_cond_dict(text=TEXTS[:rows], speaker=None))
        seeds = 21 if rows == 1 else [21 + i for i in range(rows)]
        runs, per_row, chunks = [], {i: [] for i in range(rows)}, 0
        real_prefill = model._prefill

        def spy(*args, **kwargs):
            runs.append(real_prefill(*args, **kwargs))
            return runs[-1]

        model._prefill = spy
        reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = None
            if rows == 1:
                for chunk in model.stream_generate(prefix, max_new_tokens=TRANSFORMER_NEW_TOKENS,
                                                   seed=seeds):
                    first = first if first is not None else time.perf_counter() - t0
                    per_row[0].append(chunk)
                    chunks += 1
            else:
                for events in model.stream_generate_batch(
                        prefix, max_new_tokens=TRANSFORMER_NEW_TOKENS, seed=seeds,
                        batch_size=rows):
                    first = first if first is not None else time.perf_counter() - t0
                    chunks += 1
                    for i, chunk in events:
                        per_row[i].append(chunk)
            total = time.perf_counter() - t0
        finally:
            del model._prefill
        for name, n in launch_counts.items():
            counts[name] += n
        check_replayed(tag, model.decode_stats)
        run = runs[0]
        streamed = model._trim(run.delayed.cpu().numpy(), int(run.offset), None,
                               run.prefix_audio_len)
        codes = model.generate(prefix, max_new_tokens=TRANSFORMER_NEW_TOKENS, batch_size=rows,
                               seed=seeds, progress_bar=False)
        worst = 0.0
        for i in range(rows):
            if streamed[i].shape != codes[i].shape or not np.array_equal(streamed[i], codes[i]):
                fail(f"{tag} batch {rows} row {i}: the streamed codes differ from generate's")
            full = dac.decode(codes[i][None])[0, 0]
            wav = np.concatenate(per_row[i])
            if wav.shape != full.shape:
                fail(f"{tag} batch {rows} row {i}: streamed {wav.shape} samples, full {full.shape}")
            err = float(np.abs(wav - full).max()) / float(np.abs(full).max())
            if not err <= 1e-4:
                fail(f"{tag} batch {rows} row {i}: streamed waveform off by {err:.3g} x max|full|")
            worst = max(worst, err)
        audio_s = sum(c.shape[1] for c in codes) / FRAMES_PER_S
        print(f"{tag} batch {rows}: {chunks} chunks, time to first audio {first * 1e3:.1f} ms, "
              f"whole stream {total:.2f} s for {audio_s:.2f} s of audio; codes equal generate's "
              f"bit for bit; waveforms within {worst:.3g} x max|full| of the full decode "
              f"(tolerance 1e-4; {card})", flush=True)
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in TRANSFORMER_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the stream path")
    return counts


def phase_hybrid_int8(card: str, model) -> dict:
    """``[main hybrid int8]``: the flagship hybrid after ``quantize_int8()``
    at batch 8 (16 CFG rows), 130 new tokens, with the SSM state in f8, then
    int8, then int4 (``set_storage(ssm=...)``), each under the CUDA graphs,
    the launch counts zeroed before and read after each.  K7's int8 and int4
    launches must be non-zero in their runs (and the f8 K7 absent there);
    codebook 0 of the first frame, which the prefill samples before any state
    is read back, must equal the f8 run's in every row; the shares of equal
    codes (the first frame's and all) are printed, not checked.  Returns the
    int8 and int4 runs' counts, summed."""
    import numpy as np
    import torch

    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = "[main hybrid int8]"
    B = HYBRID_INT8_BATCH
    prefix = model.prepare_conditioning(make_cond_dict(text=TEXTS[:B], speaker=None))
    seeds = [31 + i for i in range(B)]
    out, total = {}, {}
    for mode in ("f8", "int8", "int4"):
        model.set_storage(ssm=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = model.generate(prefix, max_new_tokens=HYBRID_INT8_NEW_TOKENS, batch_size=B,
                               seed=seeds, progress_bar=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = dict(launch_counts)
        model.set_storage()
        check_replayed(f"{tag} {mode}", model.decode_stats)
        for c in codes:
            if c.shape[0] != 9 or not 1 <= c.shape[1] <= HYBRID_INT8_NEW_TOKENS or \
                    c.min() < 0 or c.max() >= 1024:
                fail(f"{tag} {mode}: codes of shape {c.shape}, range {c.min()}..{c.max()}")
        for name in HYBRID_INT8_KERNELS:
            if counts[name] <= 0:
                fail(f"{tag} {mode}: kernel {name} was not launched")
        k7 = "fused_state_step" if mode == "f8" else f"fused_state_step_{mode}"
        if counts[k7] <= 0:
            fail(f"{tag} {mode}: K7 ({k7}) was not launched")
        if mode != "f8" and counts["fused_state_step"] != 0:
            fail(f"{tag} {mode}: the f8 K7 ran on the {mode} state")
        steps = model.decode_stats["steps"]
        out[mode] = codes
        print(f"{tag} {mode} SSM state, batch {B}: {sum(c.shape[1] for c in codes)} frames in "
              f"{dt:.2f} s, {dt * 1e3 / steps:.2f} ms per decode step ({steps} steps, prefill "
              f"included); K7 {k7} {counts[k7]} launches; launches {counts} ({card})", flush=True)
        if mode != "f8":
            for name, n in counts.items():
                total[name] = total.get(name, 0) + n
    for mode in ("int8", "int4"):
        first0 = [a[0, 0] == b[0, 0] for a, b in zip(out[mode], out["f8"])]
        if not all(first0):
            fail(f"{tag} {mode}: codebook 0 of the first frame differs from the f8 run's")
        first = np.mean([np.mean(a[:, 0] == b[:, 0]) for a, b in zip(out[mode], out["f8"])])
        n = [min(a.shape[1], b.shape[1]) for a, b in zip(out[mode], out["f8"])]
        same = np.mean([np.mean(a[:, :k] == b[:, :k]) for a, b, k in zip(out[mode], out["f8"], n)])
        print(f"{tag} {mode} against the f8 state: codebook 0 of the first frame equal in all {B} "
              f"rows; the whole first frame's codes {100 * first:.1f}% equal, all codes "
              f"{100 * same:.1f}% equal (drift is allowed; not checked)", flush=True)
    return total


# kernel-name fragments -> the port's kernel, for the profile's per-kernel line
_PORT_KERNELS = (("flash_cluster", "K1"), ("flash_ranks", "K1"), ("cluster_pass", "K2"),
                 ("pass_ranks", "K2"), ("fused_sample", "K3"), ("tail_pass", "K4"),
                 ("tail_layer_norm", "K4"), ("snake_conv1d", "K5"),
                 ("ssd_chunked", "K6"), ("state_step", "K7"), ("int4_matmul", "K8"),
                 ("gemm_kernel", "G1"), ("row_norm_kernel", "N1"))
# kernel-name fragments -> category, for the profile summary
_CATEGORIES = (
    ("port kernels", tuple(frag for frag, _ in _PORT_KERNELS)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitK")),
)


def phase_profile(kind: str, model, prefix, card: str, batch: int = 1, sampling=None) -> None:
    """Where a decode step's time goes, for the eager loop and for the CUDA
    graphs.  A decode step in the steady state: the wall time of a generate
    of 64 new tokens (128 under the graphs, whose steps are cheap) less that
    of one of 32, the median over three such pairs under the graphs and one
    eagerly (shares are printed only
    where that median is positive and above the busy time), and the device-busy time of one of 24 less one of 8, each
    over the steps between them (the cache stays in K2's band, so each
    generate captures one graph, and the prefill, the eager first step and
    the capture cancel).  The wall times are of runs without the profiler
    (tracing a graph's replays slows them) and without the captures; the
    device-busy time is torch.profiler's kernel time (device activity only:
    the host's op events cost more to collect than the run they describe;
    its post-processing grows with the kernels traced and took most of this
    phase's time at longer traces, so the traced runs are short).  Then the top kernels and the port's kernels' ms per step of the
    24-token generate (with K3's time a launch and K4's share of the busy
    time)."""
    for graphs, more_tokens in ((False, 64), (True, 128)):
        _profile_run(kind, model, prefix, card, 32, more_tokens, batch, sampling, graphs)


def _profile_run(kind: str, model, prefix, card: str, new_tokens: int, more_tokens: int,
                 batch: int, sampling, graphs: bool) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(tokens: int) -> tuple[float, int]:
        """(wall ms without the captures, decode steps) of one generate."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        model._generate(prefix, tokens, 2.0, batch, sampling,
                        [3 + i for i in range(batch)], None, graphs=graphs)
        torch.cuda.synchronize()
        stats = model.decode_stats
        return (time.perf_counter() - t - stats["capture_s"]) * 1e3, stats["steps"]

    def profiled(tokens: int) -> tuple[float, int, float, list]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall, steps = run(tokens)
        kernels = [e for e in prof.key_averages() if e.device_type ==
                   torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        return wall, steps, sum(e.self_device_time_total for e in kernels) / 1e3, kernels

    run(8)  # a new batch's shapes: libraries pick their kernels before anything is timed
    # the steady step's wall: the median over three (short, long) pairs under the graphs, so
    # that one disturbed generate does not make it negative; one pair of the eager loop (its
    # steps are 5-10x slower and its spread is recorded beside it, PERF.md section 5)
    pairs = [(run(new_tokens), run(more_tokens)) for _ in range(3 if graphs else 1)]
    wall = statistics.median((w2 - w1) / (s2 - s1) for (w1, s1), (w2, s2) in pairs)
    wall2, steps2 = pairs[-1][1]
    traced1, traced_steps1, busy1, _ = profiled(8)
    traced2, traced_steps2, busy2, kernels = profiled(24)
    tag = f"[profile {kind}{' graphs' if graphs else ' eager'}]"
    if busy2 <= 0:
        print(f"{tag} device busy time not measured (the profiler saw no kernels) ({card})",
              flush=True)
        return
    busy = (busy2 - busy1) / (traced_steps2 - traced_steps1)
    shares = (f"{100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% idle"
              if 0 < busy <= wall else
              f"busy and idle shares not measured (steady wall {wall:.2f} ms/step, busy "
              f"{busy:.2f}: no share within 0-100%)")
    print(f"{tag} batch-{batch} decode step in the steady state: wall {wall:.2f} ms/step "
          f"(median over {len(pairs)} pairs of {more_tokens} less {new_tokens} new tokens, "
          f"{steps2 - pairs[-1][0][1]} steps), device busy "
          f"{busy:.2f} ms/step (24 less 8, {traced_steps2 - traced_steps1} steps) = "
          f"{shares} (wall under the "
          f"profiler {(traced2 - traced1) / (traced_steps2 - traced_steps1):.2f}); the whole "
          f"{more_tokens}-token generate (prefill, {steps2} steps): wall {wall2 / steps2:.2f} "
          f"ms/step without the captures ({card})", flush=True)
    n = traced_steps2  # the per-step figures below: the 24-token generate, prefill included
    by_cat: dict[str, float] = {}
    for e in kernels:
        cat = next((c for c, keys in _CATEGORIES if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    print(f"{tag} device ms/step by category (24 tokens, {n} steps): " + ", ".join(
        f"{c} {v / n:.3f}" for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1])),
        flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{tag}   {e.self_device_time_total / 1e3 / n:.4f} ms/step  "
              f"x{e.count / n:.1f}/step  {e.key[:90]}", flush=True)
    per_kernel: dict[str, list[float]] = {}
    for e in kernels:
        label = next((k for frag, k in _PORT_KERNELS if frag in e.key), None)
        if label is not None:
            ms_n = per_kernel.setdefault(label, [0.0, 0])
            ms_n[0] += e.self_device_time_total / 1e3
            ms_n[1] += e.count
    print(f"{tag} port kernels, device ms/step (launches/step): " + ", ".join(
        f"{k} {v[0] / n:.4f} (x{v[1] / n:.1f})" for k, v in sorted(per_kernel.items())),
        flush=True)
    if "N1" in per_kernel:  # the final norm's and the prefill's: the rest run folded
        print(f"{tag} N1 {per_kernel['N1'][0] / n:.4f} ms/step, "
              f"{per_kernel['N1'][1] / n:.1f} launches a step", flush=True)
    if "K3" in per_kernel:
        print(f"{tag} K3 {per_kernel['K3'][0] * 1e3 / per_kernel['K3'][1]:.2f} us a launch "
              f"inside the step (CUPTI)", flush=True)
    if "K4" in per_kernel:
        print(f"{tag} K4 {per_kernel['K4'][0] / n:.4f} ms/step = "
              f"{100 * per_kernel['K4'][0] / busy2:.1f}% of device busy", flush=True)


@contextlib.contextmanager
def norms_unfolded():
    """Every norm run as N1 before the product that reads it (the fold's row
    limits set to 0 for the block), the route the folds replaced, for an
    A/B of one tree; yields False on a port without the fold (no-op)."""
    from zonos_tpu_torch.kernels import gemm as g1
    from zonos_tpu_torch.kernels import int4_matmul as k8

    limits = [(m, n, getattr(m, n)) for m, n in ((g1, "FOLD_ROWS"), (g1, "FOLD_RMS_ROWS"),
                                                 (k8, "FOLD_MAX_ROWS")) if hasattr(m, n)]
    for m, n, _ in limits:
        setattr(m, n, 0)
    try:
        yield bool(limits)
    finally:
        for m, n, v in limits:
            setattr(m, n, v)


def phase_steady_steps(card: str) -> None:
    """``python3 chip_smoke.py --profile [--port DIR]``: the batch-1
    steady-state decode step under the CUDA graphs (``_profile_run``) on the
    paths ``phase_profile`` profiles, built as the main paths build them
    (the transformer in bf16, then quantized to int8 in place; a fresh one
    quantized to int4; the hybrid), with no checks: run beside another
    checkout's (``--port``) in turns to compare two commits' walls and idle
    shares on one card.  Each path also runs with its norms unfolded
    (``norms_unfolded``: N1, then the product) where the port folds them,
    then folded again: an A/B of the fold in one process."""
    import torch

    from zonos_tpu_torch import make_cond_dict

    for kind, modes in (("transformer", (None, "int8")), ("transformer", ("int4",)),
                        ("hybrid", (None,))):
        model = load_model(kind)
        prefix = model.prepare_conditioning(make_cond_dict(text=TEXTS[0], speaker=None))
        for mode in modes:
            if mode:
                quantize_model(kind, model, mode)
            name = kind + (f" {mode}" if mode else "")
            _profile_run(name, model, prefix, card, 32, 128, 1, None, graphs=True)
            with norms_unfolded() as folds:
                if folds:
                    _profile_run(name + " unfolded", model, prefix, card, 32, 128, 1, None,
                                 graphs=True)
            if folds:
                _profile_run(name, model, prefix, card, 32, 128, 1, None, graphs=True)
        del model
        torch.cuda.empty_cache()


def phase_profile_batch64(model, card: str) -> None:
    """``[profile transformer int8 b64]``: the int8 model's decode step at
    batch 64 with CFG (K4 at 128 rows) over the f8 KV cache, EOS banned."""
    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.ops.sampling import SamplingParams

    texts = [TEXTS[i % len(TEXTS)] for i in range(B64_BATCH)]
    prefix = model.prepare_conditioning(make_cond_dict(text=texts, speaker=None))
    model.set_storage(kv="f8")
    try:
        phase_profile("transformer int8 b64", model, prefix, card, batch=B64_BATCH,
                      sampling=SamplingParams(ban_eos=True))
    finally:
        model.set_storage()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 4b: reference checkpoints and voice cloning
# ---------------------------------------------------------------------------

REPOS = {"transformer": "Zyphra/Zonos-v0.1-transformer", "hybrid": "Zyphra/Zonos-v0.1-hybrid"}
CHECKPOINT_NEW_TOKENS = 130  # [checkpoint ...]: the greedy generate held bit for bit
# greedy decoding takes the argmax in plain torch: no K3 there
CHECKPOINT_KERNELS = {"transformer": ("decode_attention_single",) + PRODUCT_KERNELS,
                      "hybrid": ("decode_attention_single", "ssd_chunked", "fused_state_step")
                      + PRODUCT_KERNELS}
QUICKSTART_KERNELS = TRANSFORMER_KERNELS  # K1, K2, K3 and K5 (260 frames pass 256 cache rows)
QUICKSTART_TEXT = "Hello, world! This is a test of the Zonos text to speech model."
SPEAKER_SECONDS = (3, 10)  # [speaker]: the tower timed at these clip lengths; 10 s is embedded
SPEAKER_SEED, DAC_FILE_SEED, ECAPA_SEED = 4321, 8765, 2468


@contextlib.contextmanager
def temporary_models_dir():
    """A temporary local models directory, ``ZONOS_TPU_MODELS_DIR`` pointed at
    it while the block runs and restored after."""
    old = os.environ.get("ZONOS_TPU_MODELS_DIR")
    with tempfile.TemporaryDirectory() as path:
        os.environ["ZONOS_TPU_MODELS_DIR"] = path
        try:
            yield path
        finally:
            if old is None:
                os.environ.pop("ZONOS_TPU_MODELS_DIR")
            else:
                os.environ["ZONOS_TPU_MODELS_DIR"] = old


def bf16_reference(model):
    """The in-memory model as a bf16 file holds it: its fp32 leaves (the
    Fourier features; the hybrid's A_log, D, dt_bias) rounded to bf16, as the
    loader casts every leaf; the bf16 tensors themselves shared, not copied."""
    import torch

    from zonos_tpu_torch import Zonos

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cast(v) for v in tree]
        return tree.to(torch.bfloat16)

    return Zonos(model.config, params=cast(model.params), device="cuda")


def check_loaded_leaves(tag: str, kind: str, ref, loaded) -> int:
    """Every leaf of ``loaded`` equals ``ref``'s bit for bit, the
    embeddings' and heads' pad rows past the reference's zero."""
    import torch

    cfg = ref.config
    Vp, Vi, Vo = cfg.padded_vocab_size, cfg.input_vocab_size, cfg.output_vocab_size

    def walk(a, b, path):
        if isinstance(a, dict):
            if set(a) != set(b):
                fail(f"{tag} leaves {sorted(set(a) ^ set(b))} at {path} differ")
            return sum(walk(a[k], b[k], f"{path}/{k}") for k in a)
        if isinstance(a, (list, tuple)):
            return sum(walk(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(a, b)))
        if b.dtype != torch.bfloat16 or a.shape != b.shape:
            fail(f"{tag} {path}: loaded {b.dtype} {tuple(b.shape)}, expected bf16 {tuple(a.shape)}")
        if path == "/embeddings":
            a, b, pad = a[:, :Vi], b[:, :Vi], b[:, Vi:]
        elif path == "/heads":
            cols = (torch.arange(b.shape[1], device=b.device) % Vp) < Vo
            a, b, pad = a[:, cols], b[:, cols], b[:, ~cols]
        else:
            pad = None
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f"{tag} {path}: the loaded leaf differs from the in-memory model's")
        if pad is not None and pad.count_nonzero().item():
            fail(f"{tag} {path}: the vocabulary's pad rows are not zero")
        return 1

    return walk(ref.params, loaded.params, "")


def phase_checkpoint(card: str, kind: str, model, models_dir: str) -> dict:
    """``[checkpoint kind]``: the in-memory flagship exported with
    ``export_zonos_checkpoint`` into ``models_dir`` as the reference's repo
    (``config.json``, ``model.safetensors`` in bf16) and read back by
    ``Zonos.from_pretrained``: every leaf equal to the in-memory model's
    (its fp32 leaves rounded to bf16) bit for bit, and a 130-token greedy
    generate's codes equal bit for bit; with the launch counts of the loaded
    model's generate.  Prints the file's size, the write and load seconds and
    the peak device memory during the load."""
    import numpy as np
    import torch

    from zonos_tpu_torch import Zonos, export_zonos_checkpoint, make_cond_dict
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.ops.sampling import SamplingParams

    tag = f"[checkpoint {kind}]"
    ref = bf16_reference(model)
    out = os.path.join(models_dir, REPOS[kind])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = export_zonos_checkpoint(ref.config, ref.params, out)
    t_write = time.perf_counter() - t0
    gb = os.path.getsize(path) / 1e9
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded = Zonos.from_pretrained(REPOS[kind], device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    params_gb = sum(t.numel() * t.element_size() for t in _leaves(loaded.params)) / 1e9
    n = check_loaded_leaves(tag, kind, ref, loaded)

    prefix = ref.prepare_conditioning(make_cond_dict(text=TEXTS[0], speaker=None))
    if not torch.equal(prefix, loaded.prepare_conditioning(make_cond_dict(text=TEXTS[0],
                                                                          speaker=None))):
        fail(f"{tag} the loaded model's conditioning differs from the in-memory model's")
    greedy = SamplingParams.greedy()
    want = ref.generate(prefix, max_new_tokens=CHECKPOINT_NEW_TOKENS, sampling_params=greedy,
                        progress_bar=False)[0]
    reset_launch_counts()
    got = loaded.generate(prefix, max_new_tokens=CHECKPOINT_NEW_TOKENS, sampling_params=greedy,
                          progress_bar=False)[0]
    counts = dict(launch_counts)
    check_replayed(tag, loaded.decode_stats)
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"{tag} the loaded model's greedy codes differ from the in-memory model's")
    for name in CHECKPOINT_KERNELS[kind]:
        if counts[name] <= 0:
            fail(f"{tag} kernel {name} was not launched by the loaded model's generate")
    print(f"{tag} {gb:.3f} GB written in {t_write:.1f} s, read by from_pretrained in "
          f"{t_load:.1f} s (file warm in the page cache); peak device memory of the load "
          f"{peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held before, for {params_gb:.3f} GB "
          f"of parameters; {n} leaves equal bit for bit; greedy codes of {CHECKPOINT_NEW_TOKENS} "
          f"new tokens equal bit for bit ({got.shape[1]} frames); launches {counts} ({card})",
          flush=True)
    del loaded, ref
    torch.cuda.empty_cache()
    return counts


def tone_clip(seconds: float, rate: int, seed: int):
    """A 220-Hz tone plus noise, [1, samples] float32."""
    import numpy as np

    t = np.arange(int(seconds * rate)) / rate
    noise = np.random.default_rng(seed).normal(size=t.shape)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * noise).astype(np.float32)[None]


def speaker_tower_flops(frames: int, in_planes: int = 64, blocks=(10, 20, 64, 3),
                        acoustic_dim: int = 80, embd_dim: int = 256) -> float:
    """The ResNet293 tower's multiply-adds x 2 on ``frames`` mel frames (the
    convolutions, the pooling's projections and the bottleneck)."""
    H, W = acoustic_dim, frames
    flops = 2.0 * 9 * in_planes * H * W  # stem
    cin = in_planes
    for stage_idx, n in enumerate(blocks):
        cout = in_planes * 2**stage_idx
        for b in range(n):
            stride = (1 if stage_idx == 0 else 2) if b == 0 else 1
            if stride == 2:
                H, W = (H - 1) // 2 + 1, (W - 1) // 2 + 1
            flops += 2.0 * 9 * (cin + cout) * cout * H * W
            if stride != 1 or cin != cout:
                flops += 2.0 * cin * cout * H * W
            cin = cout
    feat = cin * H
    return flops + 2.0 * W * feat * 128 * 2 + 2.0 * 2 * feat * embd_dim


def phase_speaker(card: str, model, models_dir: str) -> None:
    """``[speaker]``: a ResNet293 tower and an LDA head in the reference's
    key names (random weights and BatchNorm statistics from a seed) written
    as ``.pt`` files into ``models_dir``; ``model.make_speaker_embedding`` of
    a 10-s clip at 24 kHz on the card against the port's CPU path on the same
    files (within 1e-3 x max|ref|); the tower's warm wall and device ms at 3
    and 10 s beside its FLOPs and the bound they give at the fp32 rate."""
    import numpy as np
    import torch

    from zonos_tpu_torch.models.speaker import (
        LDA_FILE,
        SPEAKER_REPO,
        TOWER_FILE,
        SpeakerEmbeddingLDA,
    )
    from zonos_tpu_torch.models.speaker.convert import random_reference_state_dicts
    from zonos_tpu_torch.models.speaker.resnet import speaker_embed_forward

    tag = "[speaker]"
    sd, lda = random_reference_state_dicts(torch.Generator().manual_seed(SPEAKER_SEED))
    repo = os.path.join(models_dir, SPEAKER_REPO)
    os.makedirs(repo, exist_ok=True)
    torch.save(sd, os.path.join(repo, TOWER_FILE))
    torch.save(lda, os.path.join(repo, LDA_FILE))
    wav = tone_clip(SPEAKER_SECONDS[-1], 24000, SPEAKER_SEED)
    t0 = time.perf_counter()
    got = model.make_speaker_embedding(wav, 24000)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = model.make_speaker_embedding(wav, 24000)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = SpeakerEmbeddingLDA(device="cpu")(wav, 24000)[1].reshape(1, 1, -1)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    if got.shape != (1, 1, 128) or got.dtype != np.float32 or not np.isfinite(got).all():
        fail(f"{tag} embedding of shape {got.shape}, dtype {got.dtype}")
    if not np.array_equal(got, again):
        fail(f"{tag} two embeddings of one clip differ")
    if not err <= 1e-3 * np.abs(want).max():
        fail(f"{tag} the card's embedding is {err:.3g} from the CPU path's "
             f"(tolerance 1e-3 x {np.abs(want).max():.3g})")
    print(f"{tag} make_speaker_embedding of a {SPEAKER_SECONDS[-1]}-s clip at 24 kHz: [1, 1, 128] "
          f"float32, max abs err {err:.3g} against the port's CPU path on the same files "
          f"(tolerance 1e-3 x {np.abs(want).max():.3g}); wall {t_first:.2f} s the first time "
          f"(files read, tower moved to the card), {t_warm:.3f} s warm, {t_cpu:.1f} s on the "
          f"CPU ({card})", flush=True)
    tower = model._spk_tower.model
    for seconds in SPEAKER_SECONDS:
        clip = tone_clip(seconds, 24000, SPEAKER_SEED)
        t0 = time.perf_counter()
        mel = tower.mel(clip, 24000)
        t_mel = time.perf_counter() - t0
        with torch.inference_mode():
            ms, _ = device_ms(lambda: speaker_embed_forward(tower.params, mel), calls=3, reps=5,
                              warmup=2)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                speaker_embed_forward(tower.params, mel)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        frames = mel.shape[-1]
        flops = speaker_tower_flops(frames)
        bound = flops / FP32_FLOPS_PER_S * 1e3
        print(f"{tag} tower at {seconds} s ({frames} frames): {ms:.2f} device ms a call, warm "
              f"wall {statistics.median(walls) * 1e3:.2f} ms (median of 3); mel on the host "
              f"{t_mel * 1e3:.1f} ms; {flops / 1e12:.3f} TFLOP, bound {bound:.2f} ms at the fp32 "
              f"rate (cuDNN fp32 convolutions, no port kernel; {card})", flush=True)


def phase_quickstart(card: str, models_dir: str) -> dict:
    """``[quickstart]``: the README's quick start through the port with every
    file from ``models_dir``: ``from_pretrained`` on the transformer,
    ``load_audio`` of a wav written here, ``make_speaker_embedding``,
    ``make_cond_dict(text, speaker, language="en-us")``, ``generate`` (default
    sampling, 260 frames, EOS banned) and ``autoencoder.save_codes``, the DAC
    read from an HF-named ``descript/dac_44khz/model.safetensors`` (weight_g
    / weight_v, written from a seed).  The launch counts are zeroed before
    and read after the chain: K1, K2, K3 and K5 must have launched."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from zonos_tpu_torch import Zonos, load_audio, make_cond_dict
    from zonos_tpu_torch.audio import save_audio
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.models.dac.codec import DACConfig, init_dac_params
    from zonos_tpu_torch.models.dac.convert import export_dac_state_dict
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.utils.checkpoint import save_safetensors

    tag = "[quickstart]"
    dac_params = init_dac_params(DACConfig(), torch.Generator().manual_seed(DAC_FILE_SEED))
    sd = export_dac_state_dict(dac_params, torch.Generator().manual_seed(DAC_FILE_SEED))
    os.makedirs(os.path.join(models_dir, "descript", "dac_44khz"), exist_ok=True)
    save_safetensors(os.path.join(models_dir, "descript", "dac_44khz", "model.safetensors"), sd)
    voice = os.path.join(models_dir, "voice.wav")
    save_audio(voice, tone_clip(SPEAKER_SECONDS[-1], 24000, SPEAKER_SEED + 1)[0], 24000)
    walls = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    reset_launch_counts()
    model = step("from_pretrained", lambda: Zonos.from_pretrained(REPOS["transformer"]))
    wav, sr = step("load_audio", lambda: load_audio(voice))
    speaker = step("make_speaker_embedding", lambda: model.make_speaker_embedding(wav, sr))
    cond = step("make_cond_dict", lambda: make_cond_dict(text=QUICKSTART_TEXT, speaker=speaker,
                                                         language="en-us"))
    prefix = step("prepare_conditioning", lambda: model.prepare_conditioning(cond))
    codes = step("generate", lambda: model.generate(
        prefix, max_new_tokens=TRANSFORMER_NEW_TOKENS, sampling_params=SamplingParams(ban_eos=True),
        progress_bar=False))
    out = os.path.join(models_dir, "sample.wav")
    step("save_codes", lambda: model.autoencoder.save_codes([out], codes))
    counts = dict(launch_counts)
    check_replayed(tag, model.decode_stats)
    c = codes[0]
    if c.shape[0] != 9 or not 1 <= c.shape[1] <= TRANSFORMER_NEW_TOKENS or c.min() < 0 or \
            c.max() >= 1024:
        fail(f"{tag} codes of shape {c.shape}, range {c.min()}..{c.max()}")
    dac = model.autoencoder
    written = _flat(dac_params)
    dac_err = max(((a - written[k].cuda()).abs().max() / written[k].abs().max().clamp_min(1e-12))
                  .item() for k, a in _flat(dac.params).items())
    if not dac_err <= 1e-5:  # weight norm folded back: g v / ||v|| within rounding of w
        fail(f"{tag} the DAC read from the models directory is {dac_err:.3g} (relative) from "
             f"the one written there")
    decoded = dac.decode(c[None])
    sr_out, data = wavfile.read(out)
    if decoded.shape != (1, 1, c.shape[1] * 512) or sr_out != 44100 or data.size == 0 or \
            data.size > c.shape[1] * 512 or not np.isfinite(decoded).all():
        fail(f"{tag} decode {decoded.shape}, the wav at {sr_out} Hz with {data.size} samples")
    for name in QUICKSTART_KERNELS:
        if counts[name] <= 0:
            fail(f"{tag} kernel {name} was not launched on the quick start")
    print(f"{tag} launches on this path: {counts}", flush=True)
    print(f"{tag} {c.shape[1]} frames -> {decoded.shape[-1]} samples at 44100 Hz (512 a frame), "
          f"the saved wav {data.size} samples after trim and fade; walls: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()) + f" ({card})", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


APPS_TEXTS = TEXTS[:4]
APPS_NEW_TOKENS = 172  # [apps]: batch_cli's budget, 2 s of audio a text
APPS_TRACE_STEPS = 64  # [apps]: cli --verbose_sampling's decode steps (EOS banned: exactly these)
APPS_SRT = ("1\n00:00:00,000 --> 00:00:01,200\nThe quick brown fox jumps over the lazy dog.\n\n"
            "2\n00:00:01,500 --> 00:00:02,500\nSpeech synthesis is wonderful.\n\n"
            "3\n00:00:03,000 --> 00:00:03,800\nHow are you today?\n")
APPS_KERNELS = ("gemm", "gemm_norm", "row_norm", "decode_attention_single", "fused_sample",
                "snake_conv1d")


def phase_apps(card: str, models_dir: str) -> dict:
    """``[apps]``: the offline apps on the card as a user runs them, each
    through its own ``main`` and ``load_model`` (the transformer read from
    ``models_dir``, where ``[checkpoint transformer]`` wrote it, and the DAC
    ``[quickstart]`` wrote): ``batch_cli`` over four texts in one batch
    (scored), ``srt`` over a three-segment SRT written here (4 candidates a
    segment, the concatenation), and ``cli --verbose_sampling`` for 64 decode
    steps (EOS banned through a wrapped ``generate``), whose trace lines are
    counted: one a step, read at the polls.  Prints each app's wall and its
    WAVs' sample counts at 44.1 kHz; the launch counts are zeroed before and
    read after: G1, N1, K2, K3 and K5."""
    import logging

    import torch

    from zonos_tpu_torch.apps import batch_cli, cli, common, srt
    from zonos_tpu_torch.audio.io import load_audio
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.models.tts import SYNC_INTERVAL
    from zonos_tpu_torch.ops import sampling

    tag = "[apps]"
    out_dir = os.path.join(models_dir, "apps")
    os.makedirs(out_dir, exist_ok=True)
    walls, made = {}, []
    real_load = common.load_model

    def load(args):  # the apps' own loader; the model kept for its decode stats
        m = real_load(args)
        made.append(m)
        if args.verbose_sampling:  # EOS banned, so that the trace spans the polls
            generate = m.generate

            def banned(*a, **kw):
                kw["sampling_params"] = {**kw["sampling_params"], "ban_eos": True}
                return generate(*a, **kw)

            m.generate = banned
        return m

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    def samples(paths) -> list[int]:
        rates_and_lengths = [(load_audio(p)[1], load_audio(p)[0].shape[1]) for p in paths]
        if any(sr != 44100 or n == 0 for sr, n in rates_and_lengths):
            fail(f"{tag} WAVs at (rate, samples) {rates_and_lengths}")
        return [n for _, n in rates_and_lengths]

    for mod in (batch_cli, cli, srt):
        mod.load_model = load
    reset_launch_counts()
    try:
        paths = run("batch_cli", lambda: batch_cli.main(
            ["--text", *APPS_TEXTS, "--max_new_tokens", str(APPS_NEW_TOKENS),
             "--output_dir", os.path.join(out_dir, "batch"), "--score"]))
        batch_samples = samples(paths)
        srt_path = os.path.join(out_dir, "three.srt")
        with open(srt_path, "w") as f:
            f.write(APPS_SRT)
        run("srt", lambda: srt.main([srt_path, "--output_dir", os.path.join(out_dir, "srt"),
                                     "--candidates", "4",
                                     "--concat", os.path.join(out_dir, "srt.wav")]))
        srt_paths = [os.path.join(out_dir, "srt", f"seg_{i:04d}.wav") for i in (1, 2, 3)]
        if not all(os.path.exists(p) for p in srt_paths):
            fail(f"{tag} srt wrote {sorted(os.listdir(os.path.join(out_dir, 'srt')))}")
        srt_samples = samples(srt_paths + [os.path.join(out_dir, "srt.wav")])

        lines = []

        class Count(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        handler = Count(level=logging.DEBUG)
        trace_log = logging.getLogger("zonos_tpu_torch.sampling.trace")
        trace_log.addHandler(handler)
        trace_log.propagate = False  # counted here, not printed
        try:
            out = os.path.join(out_dir, "verbose.wav")
            run("cli --verbose_sampling", lambda: cli.main(
                ["--text", TEXTS[1], "--output", out, "--max_new_tokens",
                 str(APPS_TRACE_STEPS), "--no_progress_bar", "--verbose_sampling"]))
        finally:
            trace_log.removeHandler(handler)
            trace_log.propagate = True
            sampling.set_sampling_trace(False)
        cli_samples = samples([out])
        counts = dict(launch_counts)
    finally:
        for mod in (batch_cli, cli, srt):
            mod.load_model = real_load
    steps = made[-1].decode_stats["steps"]
    if len(lines) != steps or steps <= SYNC_INTERVAL or not all(
            line.startswith("probs: top=[[") for line in lines):
        fail(f"{tag} {len(lines)} trace lines for {steps} decode steps")
    for name in APPS_KERNELS:
        if counts[name] <= 0:
            fail(f"{tag} kernel {name} was not launched by the apps")
    print(f"{tag} launches on this path: {counts}", flush=True)
    print(f"{tag} batch_cli: {len(APPS_TEXTS)} texts in one batch, {APPS_NEW_TOKENS} new tokens, "
          f"scored, {walls['batch_cli']:.2f} s (model load included); samples at 44.1 kHz "
          f"{batch_samples} ({card})", flush=True)
    print(f"{tag} srt: 3 segments x 4 candidates, {walls['srt']:.2f} s; samples at 44.1 kHz "
          f"{srt_samples[:3]}, the concatenation {srt_samples[3]} ({card})", flush=True)
    print(f"{tag} cli --verbose_sampling: {steps} decode steps, {len(lines)} trace lines (one a "
          f"step, read at the polls), {walls['cli --verbose_sampling']:.2f} s; samples "
          f"{cli_samples} ({card})", flush=True)
    made.clear()
    torch.cuda.empty_cache()
    return counts


def phase_ecapa(card: str) -> None:
    """``[ecapa]``: ECAPA-TDNN at C 1024 (random weights from a seed) on the
    log-mel of a 3-s clip, on the card against the CPU within 1e-3 x
    max|ref|."""
    import numpy as np
    import torch

    from zonos_tpu_torch.models.speaker.ecapa import ecapa_forward, init_ecapa_params
    from zonos_tpu_torch.models.speaker.mel import log_mel_features

    tag = "[ecapa]"
    params = init_ecapa_params(torch.Generator().manual_seed(ECAPA_SEED), C=1024)
    mel = torch.from_numpy(log_mel_features(tone_clip(3, 16000, ECAPA_SEED)))
    with torch.inference_mode():
        want = ecapa_forward(params, mel).numpy()
        card_params = _to_cuda(params)
        mel_cuda = mel.cuda()
        got = ecapa_forward(card_params, mel_cuda).cpu().numpy()
        ms, _ = device_ms(lambda: ecapa_forward(card_params, mel_cuda), calls=3, reps=5)
    err = float(np.abs(got - want).max())
    if got.shape != (1, 192) or not err <= 1e-3 * np.abs(want).max():
        fail(f"{tag} shape {got.shape}, max abs err {err:.3g} against the CPU "
             f"(tolerance 1e-3 x {np.abs(want).max():.3g})")
    print(f"{tag} C 1024, a 3-s mel ({mel.shape[-1]} frames) -> [1, 192]: max abs err {err:.3g} "
          f"against the CPU (tolerance 1e-3 x {np.abs(want).max():.3g}); {ms:.2f} device ms a "
          f"call ({card})", flush=True)


def _flat(tree, path: str = "") -> dict:
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


# ---------------------------------------------------------------------------
# phase 4c: serving
# ---------------------------------------------------------------------------

# [serve ...]: four requests of one cond bucket (64 phoneme tokens), so that they co-batch
SERVE_TEXTS = (TEXTS[0], TEXTS[3], TEXTS[5], TEXTS[6])
SERVE_SECONDS = 2.0
SERVE_STREAMS = 2
# K1 runs in the long-form segments: each has a step budget of 512 frames (past 256 cache rows)
SERVE_KERNELS = TRANSFORMER_KERNELS
SERVE_INT8_KERNELS = ("decode_attention_single", "fused_sample", "snake_conv1d",
                      "fused_layer_tail") + PRODUCT_KERNELS
# a 3-s segment budget splits this text into three segments
LONG_TEXT = " ".join((TEXTS[0], TEXTS[1], TEXTS[7]))
LONG_BUDGET, LONG_SEED, LONG_SEGMENTS = 3.0, 99, 3
# [cobatch]: one request alone and as row 0 among peers of its cond bucket (64 tokens)
COBATCH_TEXT = "Every request should sound the same alone or in a batch."
COBATCH_FRAMES, COBATCH_SEED, COBATCH_BATCHES = 256, 1234, (4, 8, 64)
COBATCH_TRACED_STEPS = 12  # decode steps the op-by-op comparison covers after the prefill
COBATCH_INT8_BATCHES = (4, 64)  # the served int8 path: held as the bf16 one is
COBATCH_HYBRID_BATCHES = (4,)  # the hybrid (8 backbone rows: its fp32 SSM state, as alone)


def _peer_texts(n: int) -> list[str]:
    names = ("Anna", "Boris", "Clara", "David", "Elena", "Felix", "Grace", "Henry", "Irene",
             "James", "Karen", "Louis", "Maria", "Nolan", "Olive", "Peter")
    things = ("a red kite", "the old map", "a green lamp", "the blue door")
    return [f"{who} found {what} near the river today."
            for who, what in itertools.product(names, things)][:n]


def _http():
    """An opener that never goes through a proxy: the server is on 127.0.0.1."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(base: str, path: str, body, timeout: float = 600.0):
    import urllib.request

    data, ctype = ((body, "audio/wav") if isinstance(body, bytes)
                   else (json.dumps(body).encode(), "application/json"))
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": ctype})
    return _http().open(req, timeout=timeout)


def _wav_samples(tag: str, data: bytes):
    """The samples of a 16-bit mono WAV body as float32 in [-1, 1]; fails
    unless it is 44.1 kHz with samples."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(data), "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2").astype(np.float32) / 32767.0
    if sr != 44100 or pcm.size == 0:
        fail(f"{tag} a WAV at {sr} Hz with {pcm.size} samples")
    return pcm


def _concurrently(fn, n: int, tag: str) -> list:
    """``fn(i)`` for i < n, each on its own thread, all started together."""
    import threading

    results, errors = [None] * n, []

    def one(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{tag} {errors or 'a request did not return'}")
    return results


class Served:
    """A ``ServerState`` over ``model`` and its HTTP server on 127.0.0.1
    (a free port), serving on a daemon thread until ``close()``."""

    def __init__(self, model, **batcher_kwargs):
        from zonos_tpu_torch.serving import ServerState, serve

        self.state = ServerState(model, model_name="flagship", **batcher_kwargs)
        self.httpd = serve(self.state, host="127.0.0.1", port=0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.state.close()


def _tts_round(tag: str, served: Served, seconds: float = SERVE_SECONDS) -> list[float]:
    """The four ``SERVE_TEXTS`` as concurrent ``/v1/tts`` requests (default
    sampling, ``seconds`` each); every WAV finite with samples, and the four
    in one batch.  Returns each request's wall."""
    import numpy as np

    batches = served.state.batcher.snapshot()["batches"]

    def one(i):
        t = time.perf_counter()
        with _post(served.base, "/v1/tts", {"text": SERVE_TEXTS[i], "max_seconds": seconds,
                                            "seed": 100 + i}) as r:
            pcm = _wav_samples(tag, r.read())
        return time.perf_counter() - t, pcm

    out = _concurrently(one, len(SERVE_TEXTS), tag)
    snap = served.state.batcher.snapshot()
    if snap["max_batch_seen"] < len(SERVE_TEXTS) or snap["batches"] != batches + 1:
        fail(f"{tag} the {len(SERVE_TEXTS)} requests did not co-batch: {snap}")
    for _, pcm in out:
        if not np.isfinite(pcm).all() or pcm.size > seconds * 44100 + 512:
            fail(f"{tag} a WAV of {pcm.size} samples (at most {seconds} s) or non-finite")
    return [wall for wall, _ in out]


def phase_serve(card: str, model, dac) -> tuple[dict, Served]:
    """``[serve transformer]``: ``python -m zonos_tpu_torch.serving``'s
    server (``ServerState`` and ``serve`` on 127.0.0.1) over the full-width
    bf16 transformer, after the batcher's ``warmup`` and ``warmup_streaming``
    (the server's ``--warmup``): four concurrent ``/v1/tts`` requests of 2 s that must
    share one batch, two concurrent ``/v1/tts/stream`` requests, and one
    ``long: true`` request with carry and three segments whose WAV must equal,
    byte for byte, the offline ``longform.synthesize_long`` on the same model
    after ``normalize_loudness``.  The launch counts are zeroed before the
    first request and read after the last: K1, K2, K3 and K5.  Prints the
    walls, each stream's time to first audio (at the client), and the CUDA
    graph captures' seconds.  Returns the counts and the server, left
    running for ``[serve speakers]``."""
    import numpy as np
    import torch

    from zonos_tpu_torch import longform
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.serving.batching import program_frames_bucket
    from zonos_tpu_torch.serving.server import wav_bytes

    tag = "[serve transformer]"
    model._autoencoder = dac
    served = Served(model, max_batch=8, max_wait_ms=500.0)
    t = time.perf_counter()
    n_warm = served.state.batcher.warmup(cond_lens=(64,), max_new_tokens=512)
    t_warm = time.perf_counter() - t
    n_warm_stream = served.state.batcher.warmup_streaming(cond_lens=(64,), max_new_tokens=512)
    t_warm_stream = time.perf_counter() - t - t_warm
    print(f"{tag} warmup: {n_warm} single-step generates (batch buckets 1-8, cond 64) in "
          f"{t_warm:.2f} s; warmup_streaming: {n_warm_stream} generates and window decodes in "
          f"{t_warm_stream:.2f} s ({card})", flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()  # the card is idle: no request is in flight
    walls = _tts_round(tag, served)
    snap = served.state.batcher.snapshot()
    capture_tts = snap["capture_seconds"]

    def stream(i):
        t = time.perf_counter()
        first, chunks = None, []
        with _post(served.base, "/v1/tts/stream", {"text": SERVE_TEXTS[i],
                                                   "max_seconds": SERVE_SECONDS,
                                                   "seed": 200 + i}) as r:
            while True:
                piece = r.read1(1 << 16)
                if not piece:
                    break
                first = first if first is not None else time.perf_counter() - t
                chunks.append(piece)
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        if pcm.size == 0:
            fail(f"{tag} stream {i} returned no samples")
        return first, time.perf_counter() - t, pcm.size

    streams = _concurrently(stream, SERVE_STREAMS, tag)
    snap = served.state.batcher.snapshot()
    capture_stream = snap["capture_seconds"] - capture_tts
    if snap["streams"] != SERVE_STREAMS:
        fail(f"{tag} {snap['streams']} streams counted, expected {SERVE_STREAMS}")

    body = {"text": LONG_TEXT, "long": True, "max_segment_seconds": LONG_BUDGET,
            "seed": LONG_SEED}
    t = time.perf_counter()
    with _post(served.base, "/v1/tts", body) as r:
        served_wav = r.read()
    t_long = time.perf_counter() - t
    snap = served.state.batcher.snapshot()
    counts = dict(launch_counts)  # the server alone: the offline run below is not counted
    capture_long = snap["capture_seconds"] - capture_tts - capture_stream

    frames = max(9, min(86 * 30, int(min(LONG_BUDGET * 1.2 + 1.0, 30.0) * 86)))
    t = time.perf_counter()
    wav, seg_codes = longform.synthesize_long(
        model, LONG_TEXT, language="en-us", sampling_params=SamplingParams(), cfg_scale=2.0,
        seed=LONG_SEED, max_segment_seconds=LONG_BUDGET, carry_frames=43,
        max_new_tokens=program_frames_bucket(frames))
    t_offline = time.perf_counter() - t
    if len(seg_codes) != LONG_SEGMENTS:
        fail(f"{tag} the long-form text split into {len(seg_codes)} segments, not "
             f"{LONG_SEGMENTS}")
    want = wav_bytes(model.autoencoder.normalize_loudness(wav, 44100, target_lufs=-23.0))
    if served_wav != want:
        a, b = _wav_samples(tag, served_wav), _wav_samples(tag, want)
        n = min(a.size, b.size)
        first = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
        fail(f"{tag} the served long-form WAV ({a.size} samples) differs from the offline "
             f"synthesize_long's ({b.size}), first at sample {first}")
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in SERVE_KERNELS:
        if counts[name] <= 0:
            fail(f"{tag} kernel {name} was not launched by the server")
    frames_long = sum(c.shape[1] for c in seg_codes)
    print(f"{tag} 4 concurrent /v1/tts requests of {SERVE_SECONDS} s in one batch of 4: walls "
          + ", ".join(f"{w:.2f}" for w in walls) + f" s; captures {capture_tts * 1e3:.1f} ms "
          f"for that batch ({card})", flush=True)
    print(f"{tag} {SERVE_STREAMS} concurrent /v1/tts/stream requests of {SERVE_SECONDS} s in one "
          f"batch: time to first audio at the client "
          + ", ".join(f"{s[0] * 1e3:.1f}" for s in streams) + " ms, walls "
          + ", ".join(f"{s[1]:.2f}" for s in streams) + f" s; captures "
          f"{capture_stream * 1e3:.1f} ms ({card})", flush=True)
    print(f"{tag} long: true with carry, {LONG_SEGMENTS} segments, {frames_long} frames "
          f"({frames_long / FRAMES_PER_S:.2f} s of audio): wall {t_long:.2f} s served, "
          f"{t_offline:.2f} s offline; WAV equal byte for byte to the offline synthesize_long "
          f"after normalize_loudness; captures {capture_long * 1e3:.1f} ms over "
          f"{LONG_SEGMENTS} generates ({card})", flush=True)
    print(f"{tag} batcher stats: {served.state.batcher.snapshot()}", flush=True)
    return counts, served


def phase_serve_speakers(card: str, served: Served, model) -> None:
    """``[serve speakers]``: ``POST /v1/speakers`` with a 16-bit WAV of a
    10-s clip at 24 kHz on the server of ``[serve transformer]``, with the
    speaker tower's files of ``[speaker]`` in the models directory: the
    stored embedding must equal ``make_speaker_embedding`` of the same
    samples bit for bit; then one ``/v1/tts`` with that ``speaker_id``."""
    import io
    import wave

    import numpy as np

    tag = "[serve speakers]"
    clip = tone_clip(SPEAKER_SECONDS[-1], 24000, SPEAKER_SEED + 2)[0]
    pcm16 = (np.clip(clip, -1, 1) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(pcm16.tobytes())
    t = time.perf_counter()
    with _post(served.base, "/v1/speakers", buf.getvalue()) as r:
        sid = json.loads(r.read())["speaker_id"]
    t_register = time.perf_counter() - t
    stored = served.state.speakers[sid]
    want = model.make_speaker_embedding((pcm16.astype(np.float32) / 32768.0)[None, :], 24000)
    if stored.shape != (1, 1, 128) or not np.array_equal(stored, want):
        fail(f"{tag} the stored embedding {stored.shape} differs from make_speaker_embedding's")
    t = time.perf_counter()
    with _post(served.base, "/v1/tts", {"text": TEXTS[2], "speaker_id": sid,
                                        "max_seconds": 1.0}) as r:
        pcm = _wav_samples(tag, r.read())
    t_tts = time.perf_counter() - t
    print(f"{tag} speaker_id {sid} registered in {t_register:.2f} s, embedding equal to "
          f"make_speaker_embedding's bit for bit; a 1-s /v1/tts with it in {t_tts:.2f} s "
          f"({pcm.size} samples; {card})", flush=True)


def phase_serve_int8(card: str, model) -> dict:
    """``[serve transformer int8]``: a server over the transformer after
    ``quantize_int8()``; one round of the four concurrent ``/v1/tts``
    requests (one batch of 4, 8 CFG rows), the launch counts zeroed before
    and read after: K2, K3, K5 and K4."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    tag = "[serve transformer int8]"
    served = Served(model, max_batch=8, max_wait_ms=500.0)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        walls = _tts_round(tag, served)
        counts = dict(launch_counts)
        snap = served.state.batcher.snapshot()
    finally:
        served.close()
    print(f"{tag} launches on this path: {counts}", flush=True)
    for name in SERVE_INT8_KERNELS:
        if counts[name] <= 0:
            fail(f"{tag} kernel {name} was not launched by the server")
    print(f"{tag} 4 concurrent /v1/tts requests of {SERVE_SECONDS} s in one batch of 4 on int8 "
          f"weights: walls " + ", ".join(f"{w:.2f}" for w in walls) + f" s; captures "
          f"{snap['capture_seconds'] * 1e3:.1f} ms ({card})", flush=True)
    return counts


def _row0(t, ref_shape, B: int):
    """Row 0's part of ``t`` (a tensor of a batch-``B`` run) for comparison
    with the batch-1 run's tensor of shape ``ref_shape``: on the first axis
    whose size is B times the reference's, the first rows (a CFG stack of
    cond over uncond rows: the first rows of each half); the whole tensor
    where no axis differs; None where the shapes do not correspond."""
    import torch

    if tuple(t.shape) == tuple(ref_shape):
        # the same shape at both batches (a weight, or rows padded to a fixed batch): the
        # first row along the first axis is the request's where rows lie there
        return t[:1] if t.dim() and t.shape[0] > 1 and B > 1 else t
    if t.dim() != len(ref_shape):
        return None
    diff = [a for a in range(t.dim()) if t.shape[a] != ref_shape[a]]
    a = diff[0]
    s1, sb = ref_shape[a], t.shape[a]
    if sb != B * s1 or any(t.shape[d] != ref_shape[d] for d in diff[1:]):
        return None
    if s1 % 2:
        return t.narrow(a, 0, s1)
    return torch.cat([t.narrow(a, 0, s1 // 2), t.narrow(a, sb // 2, s1 // 2)], dim=a)


def _same_bits(a, b) -> bool:
    """Equal values, NaN where NaN."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _tensors(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def first_difference(model, prefix_of, seeds_of, B: int,
                     steps: int = COBATCH_TRACED_STEPS) -> str:
    """The first operation whose result for the request (row 0) differs
    between batch 1 and batch ``B``: the prefill of the conditioning prefix
    ``prefix_of(rows)`` and ``steps`` eager decode steps with the seeds
    ``seeds_of(rows)`` run under a dispatch mode that keeps every aten op's output at batch 1 and compares row 0's
    part of it at batch ``B``, op by op.  A kernel of the port (launched
    through its C entry point, outside aten) is checked through the op that
    next reads its output: when that op's inputs already differ, the kernels
    launched since the previous op are named."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from zonos_tpu_torch.kernels import launch_counts
    from zonos_tpu_torch.kernels.decode_attention import band_of

    class Found(Exception):
        pass

    class Recorder(TorchDispatchMode):
        def __init__(self, rows: int, ref: list | None):
            super().__init__()
            self.rows, self.ref, self.log, self.stage = rows, ref, [], ""
            self.before = dict(launch_counts)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if "empty" in str(func):  # an allocation: its bits are whatever the memory held,
                return func(*args, **kwargs)  # and a kernel's scratch may differ by the rows
            launched = {k: n - self.before[k] for k, n in launch_counts.items()
                        if n != self.before[k]}
            ins = _tensors(args) + _tensors(list(kwargs.values())) if launched else []
            out = func(*args, **kwargs)
            self.before = dict(launch_counts)
            outs = _tensors(out)
            i = len(self.log)
            if self.ref is None:
                self.log.append((str(func), self.stage, [t.detach().clone() for t in ins],
                                 [t.detach().clone() for t in outs]))
                return out
            if i >= len(self.ref):
                raise Found(f"the batch-{self.rows} run has more ops than batch 1's, from "
                            f"op #{i} {func} ({self.stage})")
            name, stage, ref_ins, ref_outs = self.ref[i]
            self.log.append(None)
            if name != str(func):
                raise Found(f"the op sequences part at op #{i} ({stage}): {name} at batch 1, "
                            f"{func} at batch {self.rows}")
            for got, want in zip(ins, ref_ins):
                part = _row0(got, want.shape, self.rows)
                want = want[:part.shape[0]] if part is not None and part.dim() else want
                if part is not None and not _same_bits(part, want):
                    raise Found(f"kernel(s) {sorted(launched)} launched before op #{i} {name} "
                                f"({stage}): their output for row 0 differs")
            for got, want in zip(outs, ref_outs):
                part = _row0(got, want.shape, self.rows)
                want = want[:part.shape[0]] if part is not None and part.dim() else want
                if part is not None and not _same_bits(part, want):
                    err = float((part.float() - want.float()).abs().max()) \
                        if part.is_floating_point() else float("nan")
                    shapes = [tuple(t.shape) for t in _tensors(args)]
                    raise Found(f"op #{i} {name} ({stage}): its output for row 0 differs (max "
                                f"abs diff {err:.3g}, inputs {shapes} at batch {self.rows}; its "
                                f"inputs for row 0 equal)")
            return out

    def run(rows: int, ref):
        rec = Recorder(rows, ref)
        with torch.inference_mode():
            prefix = prefix_of(rows)
            with rec:
                rec.stage = "prefill"
                dr = model._prefill(prefix, COBATCH_FRAMES, 2.0, rows, None, seeds_of(rows), None)
                for step in range(steps):
                    rec.stage = f"decode step {step + 1}"
                    model._decode_step(dr, band_of(dr.pos0 + step + 1))
        torch.cuda.synchronize()
        return rec.log

    ref = run(1, None)
    try:
        run(B, ref)
    except Found as e:
        return str(e)
    return (f"none: all {len(ref)} ops of the prefill and {steps} decode steps give row 0 the "
            f"same bits at batch {B}")


def _cobatch_isolated(model) -> list[str]:
    """Rows 0 and B of a batch against the same two rows alone (the CFG
    pair), bit for bit, for each operation of the step whose kernel or plan
    the row count could choose: every layer-0 product and the heads through
    ``matmul_w`` (G1, M = 2 against 2B), the prefill's ``w2`` (M = 2 x 71
    against 2B x 71), int4 products through ``matmul_w`` (K8, in chunks of 64
    rows past 64), the layer norm (N1), the prefill's attention (torch: fp32
    scores, softmax, bf16 values, over B x H_kv), K2 and K1 (``band_plan``)
    and K4 (``split_count``, on int8 weights made here)."""
    import torch

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_single,
        flash_decode_attention,
    )
    from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail
    from zonos_tpu_torch.ops.attention import fresh_prefill_attention
    from zonos_tpu_torch.ops.norms import layer_norm
    from zonos_tpu_torch.ops.quant import matmul_w

    gen = torch.Generator(device="cuda").manual_seed(COBATCH_SEED)
    batches = (2,) + COBATCH_BATCHES

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def against(name, fn, make):
        """fn on the two rows of make(1), and on the 2B rows of make(B) with
        the pair placed at rows 0 and B."""
        one = make(1)
        ref = fn(*one)
        same = []
        for B in batches:
            args = make(B)
            for a, a1 in zip(args, one):
                a[[0, B]] = a1
            same.append(f"{2 * B}:{'=' if torch.equal(fn(*args)[[0, B]], ref) else 'x'}")
        return f"{name}: " + " ".join(same)

    lines = []
    lp = model.params["backbone"]["layers"]
    with torch.inference_mode():
        for name in ("wqkv", "wo", "w1", "w2"):
            w = lp[name][0]
            lines.append(against(f"{name} {tuple(w.shape)} product (matmul_w), rows",
                                 lambda x, w=w: matmul_w(x, w),
                                 lambda B, w=w: (rnd(2 * B, w.shape[0]),)))
        w = model.params["heads"]
        lines.append(against(f"heads {tuple(w.shape)} product (matmul_w), rows",
                             lambda x: matmul_w(x, w), lambda B: (rnd(2 * B, w.shape[0]),)))
        w = lp["w2"][0]
        L = 71
        lines.append(against(f"prefill w2 product [2B x {L}, {w.shape[0]}] (matmul_w), rows",
                             lambda x: matmul_w(x, w), lambda B: (rnd(2 * B, L, w.shape[0]),)))
        w4 = int4_weight(gen, *FLAGSHIP_WEIGHTS["w2"])
        lines.append(against("int4 w2 product (matmul_w: K8, chunks of 64 rows), rows",
                             lambda x: matmul_w(x, w4),
                             lambda B: (rnd(2 * B, FLAGSHIP_WEIGHTS["w2"][0]),)))
        d = lp["norm1_scale"].shape[-1]
        lines.append(against("layer norm (N1), rows",
                             lambda x: layer_norm(x, lp["norm1_scale"][0], lp["norm1_bias"][0]),
                             lambda B: (rnd(2 * B, L, d),)))
        Hkv, H, D, S = 4, 16, 128, 1024
        lines.append(against(f"prefill attention over {L} rows (torch), rows",
                             lambda q, k, v: fresh_prefill_attention(q, k, v),
                             lambda B: (rnd(2 * B, L, H, D), rnd(2 * B, L, Hkv, D),
                                        rnd(2 * B, L, Hkv, D))))
        for name, fn, length in (("K2", decode_attention_single, 200),
                                 ("K1", flash_decode_attention, 700)):
            lines.append(against(f"{name} at length {length}, rows",
                                 lambda q, k, v, fn=fn, length=length: fn(q, k, v,
                                                                          *on_card(length)),
                                 lambda B: (rnd(2 * B, 1, H, D), rnd(2 * B, Hkv, S, D),
                                            rnd(2 * B, Hkv, S, D))))
        tail = layer_tail_args(gen, 2)
        lines.append(against("K4 (int8 tail), rows", lambda a, r: fused_layer_tail(a, r, *tail[2:]),
                             lambda B: (rnd(2 * B, tail[0].shape[1]), rnd(2 * B, tail[1].shape[1]))))
    torch.cuda.synchronize()
    return lines


def _frames_differing(a, b) -> tuple[int, int | None]:
    """(frames where any codebook differs, counting a length difference as
    differing frames; the first such frame or None)."""
    import numpy as np

    n = min(a.shape[1], b.shape[1])
    diff = (a[:, :n] != b[:, :n]).any(axis=0)
    count = int(diff.sum()) + abs(a.shape[1] - b.shape[1])
    first = int(np.argmax(diff)) if diff.any() else (n if a.shape[1] != b.shape[1] else None)
    return count, first


def phase_cobatch(card: str, model, tag: str = "[cobatch]", batches=COBATCH_BATCHES,
                  full: bool = True, trace: bool = False) -> dict:
    """``[cobatch]``: does a request's output on the card depend on its
    co-batched peers?  One request (its text, a speaker from the seed, seed
    1234, default sampling, 256 frames) through the batcher's own
    ``build_batch_prefix`` and ``generate`` alone at batch 1, and as row 0 at
    each of ``batches`` among peers of other texts, speakers and seeds in the
    same cond bucket.  Prints the frames that differ from the solo codes at
    each batch and whether row 0's conditioning prefix is the solo one bit
    for bit; the first operation of the prefill and 12 decode steps whose
    row-0 result differs between batch 1 and the first batch
    (``first_difference``: always with ``full`` or ``trace``, else where a
    batch differed); with ``full``, the request in all 4 rows against alone
    and, operation by operation, a row alone against inside a batch
    (``_cobatch_isolated``).  It fails if row 0's conditioning differs, or
    if any frame of row 0 (or, with ``full``, of the request in all 4 rows)
    differs from the solo codes: the contract the served paths keep on the
    card (G1, N1, the batch-free plans of K1, K2, K4 and K8, and on the
    hybrid K7's B.C and the causal conv's taps in tap order)."""
    import numpy as np
    import torch

    from zonos_tpu_torch import make_cond_dict
    from zonos_tpu_torch.serving import build_batch_prefix

    rng = np.random.default_rng(COBATCH_SEED)
    request = make_cond_dict(text=COBATCH_TEXT,
                             speaker=rng.normal(size=(1, 1, 128)).astype(np.float32))
    peers = [make_cond_dict(text=t, speaker=rng.normal(size=(1, 1, 128)).astype(np.float32))
             for t in _peer_texts(max(batches) - 1)]

    def run(B: int):
        prefix = build_batch_prefix(model, [request] + peers[:B - 1], 32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = model.generate(prefix, max_new_tokens=COBATCH_FRAMES, batch_size=B,
                               seed=[COBATCH_SEED] + [5000 + i for i in range(B - 1)],
                               progress_bar=False)
        torch.cuda.synchronize()
        return prefix, codes[0], time.perf_counter() - t

    prefix1, solo, t1 = run(1)
    result = {"solo_frames": int(solo.shape[1])}
    faults = []
    print(f"{tag} the request alone: {solo.shape[1]} frames in {t1:.2f} s ({card})", flush=True)
    for B in batches:
        prefix, codes, dt = run(B)
        if prefix.shape[1] != prefix1.shape[1]:
            fail(f"{tag} batch {B}: a peer left the request's cond bucket "
                 f"({prefix.shape[1]} rows, alone {prefix1.shape[1]})")
        same_prefix = torch.equal(prefix[0], prefix1[0]) and torch.equal(prefix[B], prefix1[1])
        if not same_prefix:
            fail(f"{tag} batch {B}: row 0's conditioning prefix differs from the solo one")
        n, first = _frames_differing(solo, codes)
        if n:
            faults.append(f"batch {B}: {n} frames differ from frame {first}")
        result[B] = {"frames": int(codes.shape[1]), "differing": n, "first": first,
                     "prefix_equal": same_prefix}
        print(f"{tag} batch {B}: row 0 {codes.shape[1]} frames, {n} differ from the solo codes "
              f"(first at frame {first}); its conditioning prefix "
              f"{'equal to' if same_prefix else 'differs from'} the solo one bit for bit; "
              f"generate {dt:.2f} s ({card})", flush=True)
    if full or trace or faults:
        t = time.perf_counter()
        where = first_difference(
            model, lambda rows: build_batch_prefix(model, [request] + peers[:rows - 1], 32),
            lambda rows: [COBATCH_SEED] + [5000 + i for i in range(rows - 1)], batches[0],
            steps=COBATCH_TRACED_STEPS)
        result["first_difference"] = where
        print(f"{tag} first operation of the prefill and {COBATCH_TRACED_STEPS} decode steps whose "
              f"row-0 result differs between batch 1 and batch {batches[0]}: {where} "
              f"({time.perf_counter() - t:.1f} s to trace)", flush=True)
    if full:
        B = batches[0]
        same = model.generate(torch.cat([prefix1[0:1]] * B + [prefix1[1:2]] * B, dim=0),
                              max_new_tokens=COBATCH_FRAMES, batch_size=B,
                              seed=[COBATCH_SEED] * B, progress_bar=False)
        n, first = _frames_differing(solo, same[0])
        rows_equal = all(np.array_equal(same[0], c) for c in same)
        if n or not rows_equal:
            faults.append(f"the request in all {B} rows: {n} frames differ from frame {first}, "
                          f"rows {'equal' if rows_equal else 'unequal'}")
        result["identical_rows"] = {"differing": n, "first": first, "rows_equal": rows_equal}
        print(f"{tag} the request in all {B} rows (its prefix and seed): {n} frames differ from "
              f"the solo codes (first at frame {first}), the rows "
              f"{'equal' if rows_equal else 'unequal'} to each other ({card})", flush=True)
        for line in _cobatch_isolated(model):
            print(f"{tag} row 0 alone (2 rows with CFG) against inside 2B rows, = equal, x "
                  f"differs: {line}", flush=True)
    print(json.dumps({"cobatch": result, "tag": tag, "card": card}), flush=True)
    if faults:
        fail(f"{tag} a request's codes depend on its co-batched peers: " + "; ".join(faults))
    return result


# ---------------------------------------------------------------------------
# phase 4c: training on the card
# ---------------------------------------------------------------------------

# bench.py's flagship training row: batch 2 of 896 frames, 48 left-padded phoneme ids (8 pads)
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_PHONEMES = 2, 896, 48
HYBRID_TRAIN_FRAMES = 512
# 2 Adafactor steps, then 3 AdamW steps, remat on (activations of one layer at a time), on one
# fixed batch with one set of CFG dropout masks
TRAIN_ADAFACTOR_STEPS, TRAIN_ADAMW_STEPS = 2, 3
TRAIN_LR, TRAIN_UNCOND_P, TRAIN_SEED = 1e-3, 0.1, 2024
LORA_RANK, LORA_ALPHA, LORA_STEPS = 8, 16.0, 5
HYBRID_TRAIN_STEPS = 5
# the autograd routes' checks: G1 and N1 at 2 x 1024 rows, K6 at B 2, L 1024
AUTOGRAD_ROWS, AUTOGRAD_SSD_L = 2 * 1024, 1024
# [train cli]: tone clips in an LJSpeech layout, the tiny transformer in bf16 (G1, N1)
CLI_TEXTS = TEXTS[:6]
CLI_STEPS, CLI_RESUMED_STEPS, CLI_NEW_TOKENS = 4, 6, 86
# every training forward's kernels; the fold (G1+N1) never runs under autograd
TRAIN_KERNELS = ("gemm", "row_norm")
HYBRID_TRAIN_KERNELS = TRAIN_KERNELS + ("ssd_chunked",)


def _grads_of(fn, inputs, upstream):
    """(outputs, gradients of ``inputs``) of ``fn`` for the ``upstream``
    gradients, through autograd on fresh leaves."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, leaves, upstream)


def check_autograd(gen) -> dict:
    """The kernels' autograd routes at training shapes against
    ``torch.autograd`` through their plain versions on the card, the same
    inputs and the same upstream gradient into both: G1 (``gemm``) on w1 and
    w2 at 2 x 1024 rows; N1 as the transformer's bf16 LayerNorm [2048, 2048],
    the hybrid's fp32-residual RMSNorm [2048, 2048] and its mixer's bf16
    RMSNorm [2048, 4096]; K6 at B 2, L 1024 at the hybrid's widths, with and
    without an initial state.  Each route must launch its kernel once and
    give outputs within the kernel's tolerance (G1 1 bf16 ulp of max|ref|,
    N1 2 ulps, K6 1e-4 x max|ref|), and every input gradient the plain
    route's bits: the backward of G1 is the plain version's products, those
    of N1 and K6 recompute the plain version.  Returns the largest output
    error of each kernel."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts
    from zonos_tpu_torch.kernels import row_norm as n1
    from zonos_tpu_torch.kernels.gemm import gemm, gemm_plain
    from zonos_tpu_torch.kernels.row_norm import Norm, norm_plain
    from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain

    def routed(name, fn, inputs, upstream):
        before = launch_counts[name]
        outs, grads = _grads_of(fn, inputs, upstream)
        torch.cuda.synchronize()
        if launch_counts[name] != before + 1 or outs[0].grad_fn is None:
            fail(f"[kernels] autograd: {name} ran {launch_counts[name] - before} launches, "
                 f"grad_fn {outs[0].grad_fn}: not its route")
        return outs, grads

    def err_of(got, ref) -> tuple[float, float]:
        with torch.no_grad():
            return float((got.float() - ref.float()).abs().max()), float(ref.abs().max())

    def same_bits(tag, grads, refs):
        for i, (g, r) in enumerate(zip(grads, refs)):
            if not torch.equal(g, r):
                err = float((g.float() - r.float()).abs().max())
                fail(f"[kernels] autograd {tag}: input {i}'s gradient differs from the plain "
                     f"route's (max abs {err})")

    errs = {"gemm": 0.0, "row_norm": 0.0, "ssd_chunked": 0.0}
    M = AUTOGRAD_ROWS
    for name in ("w1", "w2"):
        din, dout = FLAGSHIP_WEIGHTS[name]
        x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5).bfloat16()
        dy = torch.randn((M, dout), generator=gen, device="cuda").bfloat16()
        (y,), grads = routed("gemm", gemm, (x, w), (dy,))
        (ref,), refs = _grads_of(gemm_plain, (x, w), (dy,))
        err, top = err_of(y, ref)
        if not err <= bf16_ulp(top):
            fail(f"[kernels] autograd gemm {name} M={M}: max abs err {err} > 1 bf16 ulp of {top}")
        same_bits(f"gemm {name}", grads, refs)
        errs["gemm"] = max(errs["gemm"], err)
    norms = (("LayerNorm bf16", 2048, torch.bfloat16, False, True),
             ("RMSNorm fp32 x", 2048, torch.float32, True, False),
             ("RMSNorm bf16 d 4096", 4096, torch.bfloat16, True, False))
    for label, d, dtype, rms, with_bias in norms:
        x = (3 + 2 * torch.randn((M, d), generator=gen, device="cuda")).to(dtype)
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        inputs = (x, scale, bias) if with_bias else (x, scale)
        dy = torch.randn((M, d), generator=gen, device="cuda").to(dtype)

        def route(x, s, b=None):
            return n1.rms_norm(x, s, 1e-5, b) if rms else n1.layer_norm(x, s, b, 1e-5)

        def plain(x, s, b=None):
            return norm_plain(x, Norm(s, b, 1e-5, rms))

        (y,), grads = routed("row_norm", route, inputs, (dy,))
        (ref,), refs = _grads_of(plain, inputs, (dy,))
        err, top = err_of(y, ref)
        ulp = bf16_ulp(top) if dtype == torch.bfloat16 else top * 2.0 ** -22
        if not err <= 2 * ulp:
            fail(f"[kernels] autograd row_norm {label}: max abs err {err} > 2 ulps of {top}")
        same_bits(f"row_norm {label}", grads, refs)
        errs["row_norm"] = max(errs["row_norm"], err)
    for with_init in (False, True):
        args = ssd_inputs(gen, 2, AUTOGRAD_SSD_L)
        args = args if with_init else args[:6]
        upstream = (torch.randn(args[0].shape, generator=gen, device="cuda"),
                    torch.randn((2, SSM_H, SSM_P, SSM_N), generator=gen, device="cuda"))
        outs, grads = routed("ssd_chunked", ssd_chunked, args, upstream)
        refs_out, refs = _grads_of(ssd_chunked_plain, args, upstream)
        for what, got, ref in zip(("y", "final state"), outs, refs_out):
            err, top = err_of(got, ref)
            if not err <= 1e-4 * top:
                fail(f"[kernels] autograd ssd_chunked {what} (init {with_init}): max abs err "
                     f"{err} > 1e-4 x {top}")
            errs["ssd_chunked"] = max(errs["ssd_chunked"], err)
        same_bits(f"ssd_chunked (init {with_init})", grads, refs)
    print(f"[kernels] autograd routes ok: G1 on w1 and w2 at {M} rows, N1 (bf16 LayerNorm, fp32-x "
          f"RMSNorm, bf16 RMSNorm of 4096) at {M} rows, K6 at B 2, L {AUTOGRAD_SSD_L} with and "
          f"without an initial state: each launched once a call, outputs within the kernels' "
          f"tolerances (max abs err G1 {errs['gemm']:.3g}, N1 {errs['row_norm']:.3g}, K6 "
          f"{errs['ssd_chunked']:.3g}), every input gradient the plain route's bits", flush=True)
    return errs


def train_batch(model, frames: int, seed: int = TRAIN_SEED) -> tuple:
    """A loader-shaped batch: TRAIN_BATCH rows of ``frames`` seeded random
    codes (on the model's device), TRAIN_PHONEMES phoneme ids left-padded by 8, and a
    seeded value for every other conditioner, so that every leaf of the
    conditioner is reached."""
    import numpy as np
    import torch

    from zonos_tpu_torch.text.symbols import PAD_ID

    rng = np.random.default_rng(seed)
    B = TRAIN_BATCH
    codes = torch.as_tensor(rng.integers(0, 1024, (B, 9, frames)), device=model.device)
    inputs = {}
    for s in model.specs:
        if s.type == "Espeak":
            ph = np.full((B, TRAIN_PHONEMES), PAD_ID, np.int32)
            ph[:, 8:] = rng.integers(4, 100, (B, TRAIN_PHONEMES - 8))
            inputs[s.name] = ph
        elif s.type == "Integer":
            inputs[s.name] = rng.integers(0, 100, (B, 1, 1)).astype(np.int32)
        elif s.type == "Passthrough":
            inputs[s.name] = rng.normal(size=(B, 1, s.cond_dim)).astype(np.float32)
        else:
            inputs[s.name] = rng.uniform(s.min_val, s.max_val,
                                         (B, 1, s.input_dim)).astype(np.float32)
    return inputs, codes


def _check_leaf_grads(tag: str, loss_fn, trainable) -> None:
    """Every floating leaf of ``trainable`` gets a gradient from one forward
    and backward of ``loss_fn``, and every gradient is finite."""
    import torch

    from zonos_tpu_torch.parallel.train import tree_flatten, value_and_grad

    loss, grads = value_and_grad(loss_fn, trainable)
    leaves, g = tree_flatten(trainable)[0], tree_flatten(grads)[0]
    missing = sum(1 for p, x in zip(leaves, g) if p is not None and x is None)
    present = [x for x in g if x is not None]
    finite = bool(torch.stack([torch.isfinite(x).all() for x in present]).all())
    if missing or not finite or not bool(torch.isfinite(loss)):
        fail(f"{tag} first step: {missing} of {len(present) + missing} leaves without a "
             f"gradient, gradients finite {finite}, loss {float(loss)}")
    print(f"{tag} first step: every one of the {len(present)} trainable leaves has a finite "
          f"gradient (loss {float(loss):.4f})", flush=True)


def _train_steps(tag: str, card: str, runs, frames_a_step: int) -> dict:
    """Run ``runs`` (a list of (label, step callable)) in order, each step
    synced and timed, the last under ``torch.profiler`` (its device time by
    category and its top kernels; its wall is left out of ms/step); the loss
    must be finite and fall from the first step to the last, and every step
    must launch G1 and N1 (and never the fold).  Prints ms/step (the median
    of the steps between the first and the profiled one), frames/s, peak
    device memory and the launches a step."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels import launch_counts, launches_since

    losses, walls, per_step = [], [], []
    for i, (label, step) in enumerate(runs):
        before = dict(launch_counts)
        traced = i == len(runs) - 1
        with profile(activities=[ProfilerActivity.CUDA]) if traced else \
                contextlib.nullcontext() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append(launches_since(before))
        print(f"{tag} step {len(losses)} ({label}{', profiled' if traced else ''}): loss "
              f"{loss:.4f}, {walls[-1] * 1e3:.1f} ms, launches {per_step[-1]}", flush=True)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_cat: dict[str, float] = {}
    for e in kernels:
        cat = next((c for c, keys in _CATEGORIES if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    if busy > 0:
        print(f"{tag} profiled step: device busy {busy:.1f} ms of a {walls[-1] * 1e3:.1f} ms wall "
              f"under the profiler; by category: " + ", ".join(
                  f"{c} {v:.1f} ms" for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1])),
              flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"{tag}   {e.self_device_time_total / 1e3:.2f} ms  x{e.count}  {e.key[:100]}",
                  flush=True)
    else:
        print(f"{tag} profiled step: device time not measured (the profiler saw no kernels)",
              flush=True)
    for i, launched in enumerate(per_step):
        if any(launched.get(k, 0) <= 0 for k in TRAIN_KERNELS) or launched.get("gemm_norm", 0):
            fail(f"{tag} step {i + 1} launched {launched}: G1 and N1 must run, the fold never "
                 f"under autograd")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{tag} the loss did not fall over {len(losses)} steps on one batch: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = 1e3 * statistics.median(walls[1:-1])
    stats = {"losses": losses, "ms_per_step": ms, "frames_per_s": frames_a_step / (ms / 1e3),
             "peak_gib": peak, "launches_per_step": per_step[-1], "first_step_ms": walls[0] * 1e3,
             "profiled_busy_ms": busy, "profiled_by_category_ms": by_cat}
    print(f"{tag} {len(losses)} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{ms:.1f} ms/step (median of steps 2-{len(walls) - 1}, {walls[0] * 1e3:.1f} ms "
          f"first), "
          f"{stats['frames_per_s']:.0f} frames/s ({frames_a_step} frames a step), peak device "
          f"memory {peak:.2f} GiB; launches a step G1 {per_step[-1].get('gemm', 0)}, N1 "
          f"{per_step[-1].get('row_norm', 0)}, K6 {per_step[-1].get('ssd_chunked', 0)} "
          f"({card})", flush=True)
    return stats


def phase_train_transformer(card: str, model) -> tuple[dict, dict]:
    """``[train transformer]``: the full-width, full-depth flagship in bf16
    (G1 on every product), bench.py's batch (2 x 896 frames) with seeded
    conditioning; every trainable leaf's gradient checked once, then
    TRAIN_ADAFACTOR_STEPS Adafactor steps and TRAIN_ADAMW_STEPS AdamW steps
    with remat, CFG dropout at TRAIN_UNCOND_P with one set of masks.
    Returns (the phase's launch counts, its statistics)."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.parallel.train import (
        conditioned_loss,
        make_conditioned_train_step,
        make_optimizer,
    )

    tag = "[train transformer]"
    cfg, specs = model.config, model.specs
    inputs, codes = train_batch(model, TRAIN_FRAMES)

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _check_leaf_grads(tag, lambda p: conditioned_loss(cfg, specs, p, inputs, codes, gen(),
                                                      TRAIN_UNCOND_P, remat=True), model.params)
    state = {"params": model.params}
    runs = []
    for kind, n in (("adafactor", TRAIN_ADAFACTOR_STEPS), ("adamw", TRAIN_ADAMW_STEPS)):
        opt = make_optimizer(lr=TRAIN_LR, kind=kind)
        step_fn = make_conditioned_train_step(cfg, specs, opt, uncond_p=TRAIN_UNCOND_P, remat=True)

        def run(step_fn=step_fn, opt=opt):
            if state.get("opt") is not opt:
                state["opt"], state["opt_state"] = opt, opt.init(state["params"])
            state["params"], state["opt_state"], loss = step_fn(
                state["params"], state["opt_state"], inputs, codes, gen())
            return loss

        runs += [(f"{kind}, remat", run)] * n
    rows = TRAIN_BATCH * (TRAIN_PHONEMES + len(specs) - 1 + TRAIN_FRAMES + 9 - 1)
    stats = _train_steps(tag, card, runs, TRAIN_BATCH * TRAIN_FRAMES)
    counts = dict(launch_counts)
    stats["rows"] = rows
    del state
    torch.cuda.empty_cache()
    return counts, stats


def phase_train_lora(card: str, model) -> tuple[dict, dict]:
    """``[train lora]``: rank-8 adapters (alpha 16) over the frozen bf16
    flagship, the same batch, LORA_STEPS AdamW steps with remat: the loss
    falls, every adapter leaf moves and every base leaf keeps its bits."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.parallel.lora import (
        count_lora_params,
        init_lora,
        make_lora_train_step,
        merge_lora,
    )
    from zonos_tpu_torch.parallel.train import conditioned_loss, make_optimizer, tree_leaves

    tag = "[train lora]"
    cfg, specs = model.config, model.specs
    base = model.params
    kept = [t.clone() for t in tree_leaves(base)]
    inputs, codes = train_batch(model, TRAIN_FRAMES)
    adapters = init_lora(torch.Generator().manual_seed(TRAIN_SEED), base, rank=LORA_RANK)
    first = [t.clone() for t in tree_leaves(adapters)]
    print(f"{tag} rank {LORA_RANK}, alpha {LORA_ALPHA}: {count_lora_params(adapters) / 1e6:.2f} M "
          f"adapter parameters over {sum(t.numel() for t in kept) / 1e9:.3f} B frozen", flush=True)

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _check_leaf_grads(tag, lambda ad: conditioned_loss(
        cfg, specs, merge_lora(base, ad, LORA_ALPHA), inputs, codes, gen(), TRAIN_UNCOND_P,
        remat=True), adapters)
    opt = make_optimizer(lr=TRAIN_LR)
    step_fn = make_lora_train_step(cfg, specs, opt, alpha=LORA_ALPHA, uncond_p=TRAIN_UNCOND_P,
                                   remat=True)
    state = {"adapters": adapters, "opt_state": opt.init(adapters)}

    def run():
        state["adapters"], state["opt_state"], loss = step_fn(
            state["adapters"], state["opt_state"], base, inputs, codes, gen())
        return loss

    stats = _train_steps(tag, card, [("adamw, remat", run)] * LORA_STEPS, TRAIN_BATCH * TRAIN_FRAMES)
    counts = dict(launch_counts)
    changed = [not torch.equal(a, b) for a, b in zip(kept, tree_leaves(base))]
    moved = [not torch.equal(a, b) for a, b in zip(first, tree_leaves(state["adapters"]))]
    if any(changed) or not all(moved):
        fail(f"{tag} {sum(changed)} base leaves changed, {moved.count(False)} of {len(moved)} "
             f"adapter leaves did not move")
    print(f"{tag} every one of the {len(kept)} base leaves kept its bits; all {len(moved)} adapter "
          f"leaves moved", flush=True)
    del state, kept, first
    torch.cuda.empty_cache()
    return counts, stats


def phase_train_hybrid(card: str) -> tuple[dict, dict]:
    """``[train hybrid]``: the full-width, full-depth flagship hybrid in bf16
    (fp32 A_log, D, dt_bias), batch 2 x HYBRID_TRAIN_FRAMES frames, AdamW (no
    remat: the JAX package ignores it for the hybrid, as the port does):
    every leaf's gradient checked once, then the loss falls; K6 launches in
    every step's forward."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.parallel.train import (
        conditioned_loss,
        make_conditioned_train_step,
        make_optimizer,
    )

    tag = "[train hybrid]"
    model = load_model("hybrid")
    cfg, specs = model.config, model.specs
    inputs, codes = train_batch(model, HYBRID_TRAIN_FRAMES)

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _check_leaf_grads(tag, lambda p: conditioned_loss(cfg, specs, p, inputs, codes, gen(),
                                                      TRAIN_UNCOND_P), model.params)
    opt = make_optimizer(lr=TRAIN_LR)
    step_fn = make_conditioned_train_step(cfg, specs, opt, uncond_p=TRAIN_UNCOND_P)
    state = {"params": model.params, "opt_state": opt.init(model.params)}

    def run():
        state["params"], state["opt_state"], loss = step_fn(
            state["params"], state["opt_state"], inputs, codes, gen())
        return loss

    stats = _train_steps(tag, card, [("adamw", run)] * HYBRID_TRAIN_STEPS,
                         TRAIN_BATCH * HYBRID_TRAIN_FRAMES)
    counts = dict(launch_counts)
    if stats["launches_per_step"].get("ssd_chunked", 0) <= 0:
        fail(f"{tag} K6 did not launch in a training step: {stats['launches_per_step']}")
    stats["L"] = TRAIN_PHONEMES + len(specs) - 1 + HYBRID_TRAIN_FRAMES + 9 - 1
    del state, model
    torch.cuda.empty_cache()
    return counts, stats


def phase_train_cli(card: str) -> dict:
    """``[train cli]``: ``train_cli.main`` on CLI_TEXTS as seeded tone clips
    in an LJSpeech layout in a temporary directory, the tiny transformer in
    bf16 on the card: CLI_STEPS steps with a validation split, checkpoints
    and an export (the codes encoded by the DAC on the card: K5), then a
    resumed run to CLI_RESUMED_STEPS that encodes nothing and starts at step
    CLI_STEPS; the export loads through ``Zonos.from_local`` and generates
    CLI_NEW_TOKENS frames on the card."""
    import logging

    import torch

    from zonos_tpu_torch import Zonos, make_cond_dict
    from zonos_tpu_torch.apps import train_cli
    from zonos_tpu_torch.audio import save_audio
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts
    from zonos_tpu_torch.ops.sampling import SamplingParams

    tag = "[train cli]"
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logger = logging.getLogger("zonos_tpu_torch.train")
    handler = Keep(level=logging.INFO)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as root:
            os.makedirs(os.path.join(root, "ljs", "wavs"))
            rows = []
            for i, text in enumerate(CLI_TEXTS):
                save_audio(os.path.join(root, "ljs", "wavs", f"clip{i}.wav"),
                           tone_clip(1.0 + 0.2 * i, 24000, TRAIN_SEED + i)[0], 24000)
                rows.append(f"clip{i}|{text}|{text}")
            with open(os.path.join(root, "ljs", "metadata.csv"), "w") as f:
                f.write("\n".join(rows) + "\n")
            common = ["--ljspeech", os.path.join(root, "ljs"), "--tiny", "--device", "cuda",
                      "--param_dtype", "bfloat16", "--batch", "2", "--lr", "1e-3", "--warmup",
                      "0", "--log_every", "1", "--cache_dir", os.path.join(root, "cache"),
                      "--ckpt_dir", os.path.join(root, "ck"), "--ckpt_every", "2",
                      "--val_frac", "0.2", "--eval_every", "2"]
            export = os.path.join(root, "export")
            reset_launch_counts()
            t0 = time.perf_counter()
            train_cli.main(common + ["--steps", str(CLI_STEPS), "--export", export])
            torch.cuda.synchronize()
            first_wall, counts = time.perf_counter() - t0, dict(launch_counts)
            first = list(messages)
            messages.clear()
            reset_launch_counts()
            t0 = time.perf_counter()
            train_cli.main(common + ["--steps", str(CLI_RESUMED_STEPS), "--resume"])
            torch.cuda.synchronize()
            second_wall, resumed = time.perf_counter() - t0, dict(launch_counts)
            second = list(messages)
            model = Zonos.from_local(os.path.join(export, "config.json"),
                                     os.path.join(export, "model.safetensors"))
            prefix = model.prepare_conditioning(make_cond_dict(text=TEXTS[0]))
            codes = model.generate(prefix, max_new_tokens=CLI_NEW_TOKENS,
                                   sampling_params=SamplingParams(ban_eos=True),
                                   progress_bar=False)
            check_replayed(tag, model.decode_stats)
            steps_ok = sorted(os.listdir(os.path.join(root, "ck")))
    finally:
        logger.removeHandler(handler)
    fresh = [m for m in first if "fresh encodes" in m]
    if counts["snake_conv1d"] <= 0 or any(counts[k] <= 0 for k in TRAIN_KERNELS):
        fail(f"{tag} the first run launched {({k: v for k, v in counts.items() if v})}: K5 "
             f"(the data's encode), G1 and N1 must run")
    if not any(f"prepared {len(CLI_TEXTS)} examples" in m for m in first) or \
            not any(f"step {CLI_STEPS}  val_loss" in m for m in first):
        fail(f"{tag} the first run's log lacks the encode or the validation loss: {first}")
    if resumed["snake_conv1d"] or not any(f"resumed from step {CLI_STEPS}" in m for m in second) \
            or not any("0 fresh encodes" in m for m in second):
        fail(f"{tag} the resumed run launched K5 {resumed['snake_conv1d']} times or did not "
             f"resume at step {CLI_STEPS}: {second}")
    c = codes[0]
    if c.shape != (9, CLI_NEW_TOKENS) or c.min() < 0 or c.max() >= 1024:
        fail(f"{tag} the exported model generated codes of shape {c.shape}")
    losses = [m for m in first + second if "  loss " in m]
    print(f"{tag} run 1: {fresh[0] if fresh else ''}; {CLI_STEPS} steps in {first_wall:.1f} s "
          f"(K5 {counts['snake_conv1d']} launches); run 2 resumed at step {CLI_STEPS}, 0 encodes, "
          f"to step {CLI_RESUMED_STEPS} in {second_wall:.1f} s; checkpoints {steps_ok}; the "
          f"export generated {c.shape[1]} frames on the card; losses: "
          + "; ".join(m.split("  frames")[0] for m in losses) + f" ({card})", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4, meshes: the distributed part on one card
# ---------------------------------------------------------------------------


def mesh_inputs(model, batch: int = MESH_BATCH):
    """A seeded ``[2B, MESH_COND_LEN, d]`` prefix (the same on every rank) and
    the generate's arguments: EOS banned, so every step runs and the cache
    passes 256 rows (K2, then K1)."""
    import torch

    from zonos_tpu_torch.ops.sampling import SamplingParams

    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    d = model.config.backbone.d_model
    prefix = torch.randn((2 * batch, MESH_COND_LEN, d), generator=gen, device="cuda")
    kw = dict(max_new_tokens=MESH_NEW_TOKENS, batch_size=batch, seed=[5 + i for i in range(batch)],
              sampling_params=SamplingParams(ban_eos=True), progress_bar=False)
    return prefix.to(model.compute_dtype), kw


def mesh_model(mode: str, n_layer: int | None = None):
    """The full-width flagship transformer, random bf16 weights from seed 0,
    quantized to ``mode`` ("bf16", "int8" or "int4"); ``n_layer``: its
    depth cut to that many layers."""
    import copy

    from zonos_tpu_torch import Zonos, ZonosConfig
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT

    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    if n_layer is not None:
        d["backbone"]["n_layer"] = n_layer
    model = Zonos(ZonosConfig.from_dict(d), seed=0)
    if mode != "bf16":
        getattr(model, f"quantize_{mode}")()
    return model


def _counted_generate(model, prefix, kw) -> tuple[list, dict, float, dict]:
    """``model.generate`` with the launch counts zeroed just before and read
    just after: (codes, counts, wall s, decode stats)."""
    import torch

    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    codes = model.generate(prefix, **kw)
    torch.cuda.synchronize()
    return codes, dict(launch_counts), time.perf_counter() - t, dict(model.decode_stats)


def _same_codes(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(x.shape == y.shape and np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _sum_counts(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_mesh_1x1(card: str) -> dict:
    """``[mesh 1x1]``: in this process, a world of one on NCCL; the flagship
    transformer at bf16 and int8, ``Zonos.shard(make_mesh(1, 1))``: codes
    equal to the unsharded model's bit for bit, the same launches kernel by
    kernel, the decode as CUDA-graph replays."""
    import torch
    import torch.distributed as dist

    from zonos_tpu_torch.parallel import make_mesh, mesh_shape

    tag = "[mesh 1x1]"
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, "cuda:0")
    if dist.get_backend() != "nccl" or mesh_shape(mesh) != {"data": 1, "model": 1}:
        fail(f"{tag} a world of one on {dist.get_backend()}, mesh {mesh_shape(mesh)}")
    runs = []
    for mode in ("bf16", "int8"):
        model = mesh_model(mode)
        prefix, kw = mesh_inputs(model)
        warm = _counted_generate(model, prefix, kw)[0]  # the process's first generate: not timed
        ref, ref_counts, ref_s, _ = _counted_generate(model, prefix, kw)
        if not _same_codes(warm, ref):
            fail(f"{tag} {mode}: two unsharded generates with one seed differ")
        model.shard(mesh)
        codes, counts, dt, stats = _counted_generate(model, prefix, kw)
        check_replayed(f"{tag} {mode}", stats)
        if not _same_codes(codes, ref):
            fail(f"{tag} {mode}: the 1x1 mesh's codes differ from the unsharded model's")
        if {k: v for k, v in counts.items() if v} != {k: v for k, v in ref_counts.items() if v}:
            fail(f"{tag} {mode}: launches {counts} on the mesh, {ref_counts} without it")
        if stats["mesh"] != {"data": 1, "model": 1} or stats["eager"] is not None:
            fail(f"{tag} {mode}: decode stats {stats}")
        runs.append(counts)
        print(f"{tag} {mode}: batch {MESH_BATCH}, {stats['steps']} steps; codes and launches "
              f"equal to the unsharded model's ({ {k: v for k, v in counts.items() if v} }); "
              f"{stats['graphs']} CUDA graphs; {dt * 1e3 / stats['steps']:.2f} ms/step on the "
              f"mesh, {ref_s * 1e3 / stats['steps']:.2f} without ({card})", flush=True)
        del model
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"{tag} done in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return _sum_counts(*runs)


def _widened(tree):
    """Every floating leaf in fp32 (an int8 or int4 weight's integers kept):
    the same weights, computed by the plain versions in fp32."""
    if isinstance(tree, dict):
        return {k: _widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widened(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def logit_deviations(got, ref, exact) -> dict:
    """The tensor-parallel CFG logits ``got`` against the unsharded bf16
    model's ``ref`` and against ``exact``, the logits of the same weights in
    fp32: the largest deviation of each pair and the share of entries
    outside JAX's bound (rtol 0.1, atol 0.15 of the second)."""
    out = {}
    for name, a, b in (("tp_exact", got, exact), ("ref_exact", ref, exact), ("tp_ref", got, ref)):
        d = (a - b).abs()
        out[name] = float(d.max())
        out[name + "_outside"] = float((d > 0.15 + 0.1 * b.abs()).float().mean())
    return out


def mesh_rank(rank: int, shape: str, workdir: str) -> int:
    """One of the two processes of ``[mesh 1x2]`` or ``[mesh 2x1]`` (gloo,
    both on cuda:0): runs the flagship at bf16, int8 and int4 on the mesh and
    writes what it measured to ``workdir/rank<r>.json``; an error is written
    there too, with its traceback (which names the collective that failed)."""
    import traceback

    out: dict = {"modes": {}}
    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        from zonos_tpu_torch.kernels import load_all
        from zonos_tpu_torch.models.backbone import KVCache, transformer_prefill
        from zonos_tpu_torch.models.tts import apply_heads, cfg_blend
        from zonos_tpu_torch.parallel import make_mesh
        from zonos_tpu_torch.ops.tp import axis_group, model_axis

        n_data, n_model = (int(n) for n in shape.split("x"))
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                                world_size=2)
        mesh = make_mesh(n_data, n_model, "cuda:0")
        load_all(0)  # the libraries the parent built
        for mode in MESH_MODES:
            model = mesh_model(mode, MESH_TP_LAYERS if n_model > 1 else None)
            prefix, kw = mesh_inputs(model)
            res: dict = {"layers": model.config.backbone.n_layer}
            if n_model > 1:  # the prefill's CFG logits: fp32, unsharded bf16, sharded
                def logits(params, x):
                    B = kw["batch_size"]
                    cache = KVCache.create(model.config.backbone, 2 * B, MESH_COND_LEN + 8,
                                           x.dtype, "cuda")
                    hidden, _ = transformer_prefill(model.config.backbone, params["backbone"],
                                                    x, cache)
                    return cfg_blend(apply_heads(params, model.config, hidden[:, -1]), 2.0)

                with torch.inference_mode():
                    exact = logits(_widened(model.params), prefix.float())
                    ref = logits(model.params, prefix)
                model.shard(mesh)
                with torch.inference_mode(), model_axis(axis_group(mesh, "model")):
                    got = logits(model.params, prefix)
                res.update(logit_deviations(got, ref, exact))
            else:  # the unsharded model's graph-replayed codes, then the mesh's
                ref, _, _, stats = _counted_generate(model, prefix, kw)
                res["ref_graphs"] = stats["graphs"]
                model.shard(mesh)
            codes, counts, dt, stats = _counted_generate(model, prefix, kw)
            res.update(counts=counts, wall_s=dt, stats=stats,
                       codes_ok=all(c.shape[0] == 9 and c.min() >= 0 and c.max() < 1024
                                    for c in codes))
            if n_model == 1:
                res["equal"] = _same_codes(codes, ref)
            out["modes"][mode] = res
            del model
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — written for the parent, which fails the phase
        out["error"] = traceback.format_exc()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_mesh_pair(card: str, shape: str) -> dict:
    """``[mesh 1x2]`` / ``[mesh 2x1]``: two processes on the one card over
    gloo (NCCL takes no two ranks on one device), spawned after the build so
    that they load its libraries.  1x2 (tensor parallel): the prefill's CFG
    logits within rtol 0.1, atol 0.15 of the unsharded model's; each rank's
    launches show G1 (K8 at int4), K1, K2 and K3, and no K4; the steps eager
    (a gloo model axis).  2x1 (data parallel): each row's codes the
    unsharded model's graph-replayed codes bit for bit, the steps replayed.
    Both at bf16, int8 and int4 at full width; 2x1 at full depth, 1x2 at
    MESH_TP_LAYERS layers.

    The 1x2 logits are also held to the fp32 logits of the same weights
    (the plain versions in fp32): no further from them than MESH_TP_NOISE
    times the unsharded bf16 model is, and no more of them outside JAX's
    bound of them than of the unsharded model's.  (At the flagship's 26
    layers, with CFG tripling the noise, two bf16 roundings of a
    row-parallel product where the unsharded model has one put a few of
    41,472 entries just outside JAX's bound of the unsharded bf16 logits,
    which are as far from the fp32 logits as the sharded ones: PERF.md.)"""
    tag = f"[mesh {shape}]"
    t0 = time.perf_counter()
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as workdir:
        procs = []
        for rank in range(2):
            log = open(os.path.join(workdir, f"log{rank}"), "w")
            procs.append((subprocess.Popen([sys.executable, here, "--mesh-rank", str(rank), shape,
                                            workdir], stdout=log, stderr=subprocess.STDOUT,
                                           cwd=os.path.dirname(here)), log))
        try:
            rcs = [p.wait(timeout=MESH_TIMEOUT_S) for p, _ in procs]
        except subprocess.TimeoutExpired:
            rcs = None
        finally:
            for p, log in procs:
                p.kill()
                p.wait()
                log.close()
        logs = ["".join(open(os.path.join(workdir, f"log{r}")).readlines()[-30:])
                for r in range(2)]
        if rcs is None:
            fail(f"{tag} the two processes did not end in {MESH_TIMEOUT_S} s:\n" + "\n".join(logs))
        results = []
        for rank in range(2):
            path = os.path.join(workdir, f"rank{rank}.json")
            if rcs[rank] != 0 or not os.path.exists(path):
                fail(f"{tag} rank {rank} exited {rcs[rank]}:\n{logs[rank]}")
            with open(path) as f:
                results.append(json.load(f))
    for rank, res in enumerate(results):
        if "error" in res:
            fail(f"{tag} rank {rank} failed:\n{res['error']}")
    tp = shape == "1x2"
    all_counts = []
    for mode in MESH_MODES:
        for rank, res in enumerate(results):
            r = res["modes"][mode]
            counts, stats = r["counts"], r["stats"]
            all_counts.append(counts)
            want = ["flash_decode_attention", "decode_attention_single", "fused_sample",
                    "int4_matmul" if mode == "int4" else "gemm"]
            if mode == "int8" and not tp:
                want.append("fused_layer_tail")
            missing = [k for k in want if counts[k] <= 0]
            if missing or not r["codes_ok"]:
                fail(f"{tag} {mode} rank {rank}: {missing} not launched, or codes out of range "
                     f"({ {k: v for k, v in counts.items() if v} })")
            if tp:
                if counts["fused_layer_tail"] != 0:
                    fail(f"{tag} {mode} rank {rank}: K4 launched {counts['fused_layer_tail']} "
                         f"times on a model axis of 2")
                if stats["graphs"] != 0 or stats["eager"] != "gloo model axis":
                    fail(f"{tag} {mode} rank {rank}: decode stats {stats}")
                if r["tp_ref_outside"] > 0:
                    fail(f"{tag} {mode} rank {rank}: {r['tp_ref_outside']:.2e} of the CFG logits "
                         f"outside rtol 0.1, atol 0.15 of the unsharded model's (max abs err "
                         f"{r['tp_ref']})")
                if (r["tp_exact"] > MESH_TP_NOISE * r["ref_exact"]
                        or r["tp_exact_outside"] > r["ref_exact_outside"]):
                    fail(f"{tag} {mode} rank {rank}: the CFG logits are {r['tp_exact']} from the "
                         f"fp32 logits ({r['tp_exact_outside']:.2e} of them outside rtol 0.1, "
                         f"atol 0.15), the unsharded bf16 model's {r['ref_exact']} "
                         f"({r['ref_exact_outside']:.2e})")
            else:
                check_replayed(f"{tag} {mode} rank {rank}", stats)
                if not r["equal"]:
                    fail(f"{tag} {mode} rank {rank}: the data-parallel codes differ from the "
                         f"unsharded model's graph-replayed codes")
        r0 = results[0]["modes"][mode]
        steps = r0["stats"]["steps"]
        what = (f"CFG logits against the fp32 logits of the same weights: max abs err "
                f"{r0['tp_exact']:.4f}, {r0['tp_exact_outside']:.2e} of them outside rtol 0.1, "
                f"atol 0.15 (the unsharded bf16 model's {r0['ref_exact']:.4f}, "
                f"{r0['ref_exact_outside']:.2e}); against the unsharded model's: max "
                f"{r0['tp_ref']:.4f}, {r0['tp_ref_outside']:.2e} outside; eager steps, no K4"
                if tp else
                "codes of both rows bit for bit the unsharded model's graph-replayed codes; "
                f"{r0['stats']['graphs']} CUDA graphs a rank")
        print(f"{tag} {mode}: {r0['layers']} layers, batch {MESH_BATCH}, {steps} steps; {what}; "
              f"rank 0 launches "
              f"{ {k: v for k, v in r0['counts'].items() if v} }; {r0['wall_s'] * 1e3 / steps:.2f} "
              f"ms/step of the generate (two processes sharing one card, not a multi-GPU "
              f"figure; {card})", flush=True)
    print(f"{tag} done in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return _sum_counts(*all_counts)


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def _times(kernel, plain) -> dict:
    ms, host_ms = device_ms(kernel)
    return {"ms": ms, "kernel_ms": ms, "host_ms": host_ms, "plain_ms": device_ms(plain)[0]}


def _launches(name: str, counts: dict) -> dict:
    """``launches`` (the sum over the main paths) and ``launches_by_path``."""
    by_path = {kind: c[name] for kind, c in counts.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def ssd_chunked_cost(Bsz: int, L: int, H: int, G: int, P: int, N: int,
                     init_state: bool) -> tuple[float, float]:
    """(flops, bytes) K6's function needs at least: the recurrent form's 4
    flops per state element per step (y = C.h and h' = h dA + dt x B^T, as
    K7 counts them), below the chunked form's work at any chunk length; one
    read of x/dt/B/C/A/D and the init state, and one write of y and the
    final state, in fp32."""
    flops = 4.0 * Bsz * L * H * P * N
    states = Bsz * H * P * N * (2 if init_state else 1)
    nbytes = 4.0 * (Bsz * L * (2 * H * P + H + 2 * G * N) + states + 2 * H)
    return flops, nbytes


def fused_state_step_cost(BH: int, P: int, N: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) K7's function needs: 4 flops per state element; the state
    read and written once in its storage type, C, B, dA, xdt read and y
    written once in fp32."""
    return 4.0 * BH * P * N, 2.0 * BH * P * N * itemsize + 4.0 * BH * (2 * N + 1 + 2 * P)


def _bound(flops: float, nbytes: float, flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    ops_s, bytes_s = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def time_ssd_chunked(gen, rows: int, L: int) -> dict:
    """K6 at ``rows`` batch rows (2 per prefill row with CFG), flagship widths,
    from the zero state as the prefill runs it.  The bound takes the
    operations at 3xTF32's rate (a third of the TF32 tensor cores')."""
    from zonos_tpu_torch.kernels.ssd import ssd_chunked, ssd_chunked_plain

    args = ssd_inputs(gen, rows, L)[:6]
    return {"shape": f"x [{rows},{L},{SSM_H},{SSM_P}], B/C [{rows},{L},1,{SSM_N}], no init "
                     f"state, fp32",
            **_times(lambda: ssd_chunked(*args), lambda: ssd_chunked_plain(*args)),
            **_bound(*ssd_chunked_cost(rows, L, SSM_H, 1, SSM_P, SSM_N, init_state=False),
                     K6_FLOPS_PER_S),
            "bound_rate": "3xTF32 tensor cores, 495 / 3 TFLOP/s"}


def time_fused_state_step(gen, BH: int, dtype, rows: int | None = None) -> dict:
    """K7 at ``BH`` rows x heads, with B.C as the main path asks for it,
    cycling over enough states to exceed the 50 MB L2 (a layer's state is
    read after the other layers' weights);
    ``rows``: state rows a slab, launched through the C entry point in place
    of the wrapper's ``slab_plan`` (``--sweep``), None for the wrapper."""
    import torch

    from zonos_tpu_torch.kernels._build import check, library
    from zonos_tpu_torch.kernels.ssm_state import (
        _SIGNATURES,
        STATE_DTYPES,
        fused_state_step,
        fused_state_step_plain,
    )

    def with_rows(state, C, B, dA, xdt):
        BH, P, N = state.shape
        y = torch.empty((BH, P), dtype=torch.float32, device=state.device)
        check(library("ssm_state", _SIGNATURES).zt_ssm_state_step(
            state.data_ptr(), C.data_ptr(), B.data_ptr(), dA.data_ptr(), xdt.data_ptr(),
            y.data_ptr(), None, BH, P, N, STATE_DTYPES[state.dtype], rows,
            torch.cuda.current_stream().cuda_stream), "K7 sweep")
        return y, state

    bc = torch.empty(BH, device="cuda")  # the decode step's B.C beside y, as the main path asks

    def step(*args):
        return fused_state_step(*args, bc=bc) if rows is None else with_rows(*args)

    itemsize = torch.empty((), dtype=dtype).element_size()
    n_sets = 2 + int(64e6 // (BH * SSM_P * SSM_N * itemsize))
    sets = [state_step_inputs(gen, BH, dtype) for _ in range(n_sets)]
    cycle = itertools.cycle(sets)
    return {"shape": f"state [{BH},{SSM_P},{SSM_N}] {str(dtype).split('.')[-1]}, L2 cold",
            **_times(lambda: step(*next(cycle)),
                     lambda: fused_state_step_plain(*next(cycle), bc=bc)),
            **_bound(*fused_state_step_cost(BH, SSM_P, SSM_N, itemsize))}


def fused_state_step_quant_cost(BH: int, P: int, N: int, mode: str) -> tuple[float, float]:
    """(ops, bytes) K7's function needs on an int8 or int4 state: per state
    element 12 operations (the dequantizing product, C.s's 2, the update's
    3, the absmax's 2, the division, the rounding and the clamp's 2); the
    state read and written once (1 byte an element, int4 a half) with its
    fp32 scale, C, B, dA, xdt read and y written once in fp32."""
    per = {"int8": 1.0, "int4": 0.5}[mode]
    return 12.0 * BH * P * N, 2.0 * BH * P * N * per + 4.0 * BH * (2 + 2 * N + 1 + 2 * P)


def time_fused_state_step_quant(gen, BH: int, mode: str) -> dict:
    """K7 on an int8 or int4 state at ``BH`` rows x heads, with B.C, cycling
    over enough states to exceed the 50 MB L2, beside the plain version."""
    import torch

    from zonos_tpu_torch.kernels.ssm_state import fused_state_step, fused_state_step_plain

    per = {"int8": 1.0, "int4": 0.5}[mode]
    n_sets = 2 + int(64e6 // (BH * SSM_P * SSM_N * per))
    sets = [quant_state_inputs(gen, BH, mode) for _ in range(n_sets)]
    cycle = itertools.cycle(sets)
    bc = torch.empty(BH, device="cuda")
    return {"shape": f"state [{BH},{SSM_P},{SSM_N}] {mode} + scales [{BH}] fp32, L2 cold",
            **_times(lambda: fused_state_step(*next(cycle), bc=bc),
                     lambda: fused_state_step_plain(*next(cycle), bc=bc)),
            **_bound(*fused_state_step_quant_cost(BH, SSM_P, SSM_N, mode))}


def time_decode_attention_quantized(gen, name: str, storage: str, length: int,
                                    counts: dict, B: int = 2, S: int = 2048) -> dict:
    """K1 or K2 (``name``) over an f8 or int8 cache at ``B`` rows (2: batch 1
    with CFG), the current row held out, cycling over 8 caches for a cold L2
    as the bf16 timing does.  The plain version is the split math; no single
    PyTorch call reads these caches."""
    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_single_held_out,
        decode_attention_split_plain,
        flash_decode_attention_held_out,
    )

    H, Hkv, D = 16, 4, 128
    fn = flash_decode_attention_held_out if name == "flash_decode_attention" else \
        decode_attention_single_held_out
    sets = [quantized_cache(gen, storage, B, Hkv, S) + held_out_inputs(gen, B)
            for _ in range(8)]
    cycle = itertools.cycle(sets)
    pos = length - 1
    pos_t, band = on_card(pos, held_out=True)

    def call(f, **kw):
        k, v, ks, vs, q, k_new, v_new = next(cycle)
        return f(q, k, v, k_new, v_new, pos_t, ks, vs, **kw)

    nbytes = (2 * B * Hkv * pos * D * (1 + (4 / D if storage == "int8" else 0))
              + 2 * (2 * B * H * D + 2 * B * Hkv * D))
    flops = 4 * B * H * length * D
    return {"name": f"{name}_{storage}", **_launches(f"{name}_{storage}", counts),
            "shape": f"q [{B},1,{H},{D}] bf16, k/v [{B},{Hkv},{S},{D}] {storage}, length {length} "
                     f"(pos {pos} + the held-out row), L2 cold",
            **_times(lambda: call(fn, band=band), lambda: call(decode_attention_split_plain)),
            **_bound(flops, nbytes), "library_ms": None}


def time_int4_matmul(gen, label: str, din: int, dout: int, M: int,
                     n_split: int | None = None) -> dict:
    """K8 on one flagship weight at M rows (``n_split``: the kernel's split
    of the packed rows, None for its default), cycling over enough weights to
    exceed the 50 MB L2.  The library yardstick is one torch.matmul of x by
    the pre-dequantized bf16 weight: the same product, reading 4x the weight
    bytes."""
    import torch

    from zonos_tpu_torch.kernels.int4_matmul import (
        int4_matmul,
        int4_matmul_plain,
        unpack_int4,
    )

    packed = din * dout // 2
    n_sets = 2 + int(64e6 // packed)
    sets = []
    for _ in range(n_sets):
        w = int4_weight(gen, din, dout)
        x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
        wb = (unpack_int4(w["q4"]).bfloat16().reshape(din // 128, 128, dout)
              * w["s4"][:, None, :]).reshape(din, dout)
        sets.append((x, w["q4"], w["s4"], wb))
    cycle = itertools.cycle(sets)

    def call(f, **kw):
        x, q, s, _ = next(cycle)
        return f(x, q, s, **kw)

    def library_call():
        x, _, _, wb = next(cycle)
        return torch.matmul(x, wb)

    G = din // 128
    nbytes = packed + 2 * G * dout + 2 * M * din + 4 * M * dout
    return {"shape": f"{label}: x [{M},{din}] bf16 @ int4 [{din},{dout}] (q [{din // 2},{dout}], "
                     f"s [{G},{dout}]), L2 cold",
            **_times(lambda: call(int4_matmul, n_split=n_split),
                     lambda: call(int4_matmul_plain)),
            **_bound(2.0 * M * din * dout, nbytes, BF16_FLOPS_PER_S),
            "library_ms": device_ms(library_call)[0],
            "library": "torch.matmul of x by the pre-dequantized bf16 weight (4x the weight bytes)"}


def time_gemm(gen, label: str, din: int, dout: int, M: int, int8: bool = False) -> dict:
    """G1 on one flagship weight (bf16, or int8 with its scales) at M rows,
    cycling over enough weights to exceed the 50 MB L2 (one set where a set
    alone passes it).  The library yardstick is one torch.matmul of x by the
    bf16 weight (for int8: by the integers cast to bf16 beforehand, the
    product before the scales: twice the weight bytes).  Large M takes fewer
    timed calls (the plain fp32 product takes milliseconds)."""
    import torch

    from zonos_tpu_torch.kernels.gemm import gemm, gemm_plain
    from zonos_tpu_torch.ops.quant import quantize_weight_int8

    wbytes = din * dout * (1 if int8 else 2)
    n_sets = 1 if wbytes + 2 * M * din > 64e6 else 2 + int(64e6 // (wbytes + 2 * M * din))
    sets = []
    for _ in range(n_sets):
        wf = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
        x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
        if int8:
            w = quantize_weight_int8(wf)
            sets.append((x, (w["q"], w["s"]), w["q"].bfloat16()))
        else:
            sets.append((x, (wf.bfloat16(),), wf.bfloat16()))
        del wf
    cycle = itertools.cycle(sets)

    def call(f):
        x, args, _ = next(cycle)
        return f(x, *args)

    def library_call():
        x, _, wb = next(cycle)
        return torch.matmul(x, wb)

    calls, reps = (20, 21) if M <= 256 else (3, 7)
    nbytes = wbytes + (2 * dout if int8 else 0) + 2 * M * din + 2 * M * dout
    return {"shape": f"{label}: x [{M},{din}] bf16 @ {'int8' if int8 else 'bf16'} "
                     f"[{din},{dout}]{' + bf16 scales' if int8 else ''}, L2 cold",
            "ms": device_ms(lambda: call(gemm), calls, reps)[0],
            "plain_ms": device_ms(lambda: call(gemm_plain), calls, reps)[0],
            **_bound(2.0 * M * din * dout, nbytes, BF16_FLOPS_PER_S),
            "library_ms": device_ms(library_call, calls, reps)[0],
            "library": "torch.matmul" + (" by the integers pre-cast to bf16 (no scales)"
                                         if int8 else "")}


def time_row_norm(gen, rows: int, d: int = 2048) -> dict:
    """N1's LayerNorm of ``rows`` bf16 rows of width ``d`` (the flagship's
    norms: 2 rows at batch 1 with CFG, 142 in its prefill) beside the plain
    version and F.layer_norm (which computes the same function in one call),
    L2 warm as in the step."""
    import torch
    import torch.nn.functional as F

    from zonos_tpu_torch.kernels.row_norm import layer_norm, layer_norm_plain

    x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    return {"shape": f"LayerNorm of x [{rows},{d}] bf16, fp32 statistics, L2 warm",
            **_times(lambda: layer_norm(x, scale, bias), lambda: layer_norm_plain(x, scale, bias)),
            **_bound(8.0 * rows * d, 4 * rows * d + 4 * d),
            "library_ms": device_ms(lambda: F.layer_norm(x, (d,), scale, bias))[0],
            "library": "torch.nn.functional.layer_norm"}


def time_norm_fold(gen, label: str, din: int, dout: int, M: int, weight: str = "bf16",
                   dtype=None, rms: bool = False) -> dict:
    """A norm folded into the product that reads it (G1 for a bf16 or int8
    ``weight``, K8 for int4) at M rows of x in ``dtype`` (bf16, or the
    hybrid's fp32 residual), LayerNorm (or RMSNorm), cycling over enough
    weights to exceed the 50 MB L2, beside the unfused route (N1, the cast
    for fp32 x, then the product: ``unfused_ms``) and the plain composition.
    The library yardstick: F.layer_norm (F.rms_norm), the cast and one
    torch.matmul by the bf16 weight (int8: the integers pre-cast to bf16;
    int4: the pre-dequantized weight).  The bound: the weight, x, the norm's
    parameters and the output once (bytes), or 2 M K N at the bf16 rate."""
    import torch
    import torch.nn.functional as F

    from zonos_tpu_torch.kernels.gemm import gemm, gemm_plain
    from zonos_tpu_torch.kernels.int4_matmul import int4_matmul, int4_matmul_plain, unpack_int4
    from zonos_tpu_torch.kernels.row_norm import Norm, norm_plain
    from zonos_tpu_torch.ops.quant import quantize_weight_int8

    dtype = dtype or torch.bfloat16
    wbytes = din * dout * {"bf16": 2, "int8": 1, "int4": 0.5}[weight]
    n_sets = 1 if wbytes + 2 * M * din > 64e6 else 2 + int(64e6 // (wbytes + 2 * M * din))
    scale = (1 + 0.1 * torch.randn(din, generator=gen, device="cuda")).bfloat16()
    bias = None if rms else (0.1 * torch.randn(din, generator=gen, device="cuda")).bfloat16()
    norm = Norm(scale, bias, 1e-5, rms)
    sets = []
    for _ in range(n_sets):
        wf = torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5
        x = _residual(gen, M, din, dtype)
        if weight == "int4":
            w = int4_weight(gen, din, dout)
            wb = (unpack_int4(w["q4"]).bfloat16().reshape(din // 128, 128, dout)
                  * w["s4"][:, None, :]).reshape(din, dout)
            sets.append((x, (w["q4"], w["s4"]), wb))
        elif weight == "int8":
            w = quantize_weight_int8(wf)
            sets.append((x, (w["q"], w["s"]), w["q"].bfloat16()))
        else:
            sets.append((x, (wf.bfloat16(),), wf.bfloat16()))
        del wf
    cycle = itertools.cycle(sets)
    product, plain = (int4_matmul, int4_matmul_plain) if weight == "int4" else (gemm, gemm_plain)

    def fused():
        x, args, _ = next(cycle)
        return product(x, *args, norm=norm)

    def unfused():
        x, args, _ = next(cycle)
        return product(_n1(x, norm).bfloat16(), *args)

    def plain_call():
        x, args, _ = next(cycle)
        return plain(norm_plain(x, norm).bfloat16(), *args)

    lib_norm = getattr(F, "rms_norm", None) if rms else F.layer_norm

    def library_call():
        x, _, wb = next(cycle)
        h = lib_norm(x, (din,), scale.to(x.dtype), eps=1e-5) if rms else \
            lib_norm(x, (din,), scale.to(x.dtype), bias.to(x.dtype), 1e-5)
        return torch.matmul(h.bfloat16(), wb)

    nbytes = wbytes + M * din * x.element_size() + 2 * din * (1 if rms else 2) + 2 * M * dout
    return {"shape": f"{label}: {'RMSNorm' if rms else 'LayerNorm'} of x [{M},{din}] "
                     f"{str(dtype).replace('torch.', '')} folded into the product by {weight} "
                     f"[{din},{dout}], L2 cold",
            "ms": device_ms(fused)[0], "unfused_ms": device_ms(unfused)[0],
            "plain_ms": device_ms(plain_call)[0],
            **_bound(2.0 * M * din * dout, nbytes, BF16_FLOPS_PER_S),
            "library_ms": device_ms(library_call)[0] if lib_norm is not None else None,
            "library": f"F.{'rms_norm' if rms else 'layer_norm'}, the cast, torch.matmul by the "
                       + {"bf16": "bf16 weight", "int8": "integers pre-cast to bf16 (no scales)",
                          "int4": "pre-dequantized bf16 weight"}[weight]}


def fold_table(gen, card: str) -> list[dict]:
    """The folded norm against N1 and then the product by row count
    (FOLD_TIMED_ROWS) on the transformer's wqkv and w1 in bf16, the hybrid's
    in_proj (fp32 x) and out_proj (RMSNorm) at a decode step's rows, and
    K8's at its fold rows: what G1's ``folds`` and K8's FOLD_MAX_ROWS were
    set from.  Each line says which route the op layer takes."""
    import torch

    from zonos_tpu_torch.kernels.gemm import folds
    from zonos_tpu_torch.kernels.row_norm import Norm

    cases = [(name, FLAGSHIP_WEIGHTS[name], M, {}) for M in FOLD_TIMED_ROWS
             for name in ("wqkv", "w1")]
    cases += [("in_proj", HYBRID_WEIGHTS["in_proj"], M, {"dtype": torch.float32, "rms": True})
              for M in (2, 16)]
    cases += [("out_proj", HYBRID_WEIGHTS["out_proj"], M, {"rms": True}) for M in (2, 16)]
    rows = []
    for name, (din, dout), M, kw in cases:
        t = time_norm_fold(gen, name, din, dout, M, **kw)
        rows.append(t)
        fold = folds(M, Norm(None, None, 0.0, kw.get("rms", False)))
        route = "folds" if fold else "runs N1 first"
        print(f"[fold] G1 {name} M={M}{' fp32 x' if kw.get('dtype') else ''}"
              f"{' RMSNorm' if kw.get('rms') else ' LayerNorm'}: folded {t['ms'] * 1e3:.3f} us, "
              f"N1 then G1 {t['unfused_ms'] * 1e3:.3f} us; the op {route} ({card})", flush=True)
    for M in INT4_FOLD_ROWS[1:]:
        t = time_norm_fold(gen, "w1", *FLAGSHIP_WEIGHTS["w1"], M, weight="int4")
        rows.append(t)
        print(f"[fold] K8 w1 M={M}: folded {t['ms'] * 1e3:.3f} us, N1 then K8 "
              f"{t['unfused_ms'] * 1e3:.3f} us ({card})", flush=True)
    return rows


def time_layer_tail(gen, B2: int, target_ctas: int | None = None) -> dict:
    """K4 at ``B2`` rows and the flagship widths (``target_ctas``: the CTAs
    its passes aim for, None for its default), alternating two weight sets
    (2 x 54.6 MB, over the 50 MB L2).  The plain version is the unfused torch
    tail; no single PyTorch call computes it."""
    from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail, fused_layer_tail_plain

    d, I = 2048, 8192
    cycle = itertools.cycle([layer_tail_args(gen, B2) for _ in range(2)])
    weights = d * d + d * 2 * I + I * d
    nbytes = weights + 2 * (d + 2 * I + d) + 2 * (2 * d) + 2 * B2 * (2 * d) + 2 * B2 * d
    return {"shape": f"attn/resid [{B2},{d}] bf16, int8 wo [{d},{d}], w1 [{d},{2 * I}], "
                     f"w2 [{I},{d}], L2 cold",
            **_times(lambda: fused_layer_tail(*next(cycle), target_ctas=target_ctas),
                     lambda: fused_layer_tail_plain(*next(cycle))),
            **_bound(2.0 * B2 * weights, nbytes, BF16_FLOPS_PER_S)}


def time_decode_attention(gen, key: str, counts: dict, errs: dict) -> dict:
    """K1 (``key`` "K1", length 2000) or K2 ("K2", length 256) at batch 1 with
    CFG over a bf16 cache beside the plain version and SDPA, with the f8 and
    int8 caches, the f8 cache of a served batch with CFG (K1 batch 4, K2
    batch 8) and the batch-64 f8 cache (pos 1999 or 255) under ``"more"``."""
    import torch
    import torch.nn.functional as F

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_plain,
        decode_attention_single,
        flash_decode_attention,
    )

    H, Hkv, D, S = 16, 4, 128, 2048
    B = 2  # batch 1 with classifier-free guidance
    name, fn, length = (("flash_decode_attention", flash_decode_attention, 2000) if key == "K1"
                        else ("decode_attention_single", decode_attention_single, 256))
    # On the decode path a layer's cache is read after the other 25 layers'
    # weights have passed through L2, so it comes from HBM.  The timed calls
    # cycle over 8 caches (8 x 8.4 MB > the 50 MB L2) to read it cold too.
    sets = [tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((B, 1, H, D), (B, Hkv, S, D), (B, Hkv, S, D)))
            for _ in range(8)]
    q, k, v = sets[0]
    mask = (torch.arange(S, device="cuda") < length)[None, None, None, :]
    lib_ref = F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask,
                                             enable_gqa=True).transpose(1, 2).float()
    length_t, band = on_card(length)
    if not float((lib_ref - fn(q, k, v, length_t, band).float()).abs().max()) <= 4 * bf16_ulp(
            float(lib_ref.abs().max())):
        fail(f"library call disagrees with {name}")
    cycle = itertools.cycle(sets)

    def library_call():
        qq, kk, vv = next(cycle)
        return F.scaled_dot_product_attention(qq.transpose(1, 2), kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    nbytes = 2 * (2 * B * Hkv * length * D + 2 * B * H * D)
    flops = 4 * B * H * length * D
    return {
        "name": name, "id": key, "route": "cuda",
        "source": "zonos_tpu_torch/csrc/decode_attention.cu",
        "replaces": ("zonos_tpu/ops/pallas_kernels.py:147" if key == "K1"
                     else "zonos_tpu/ops/pallas_kernels.py:58"),
        **_launches(name, counts),
        "max_abs_err": errs.get(name),
        "shape": f"q [{B},1,{H},{D}] bf16, k/v [{B},{Hkv},{S},{D}] bf16, length {length}",
        **_times(lambda: fn(*next(cycle), length_t, band),
                 lambda: decode_attention_plain(*next(cycle), length_t)),
        **_bound(flops, nbytes),
        "library_ms": device_ms(library_call)[0],
        "more": [time_decode_attention_quantized(gen, name, storage, length, counts)
                 for storage in ("f8", "int8")]
                + [time_decode_attention_quantized(gen, name, "f8", length, counts,
                                                   B=2 * batch, S=S if key == "K1" else 256)
                   for batch in ((4 if key == "K1" else 8), B64_BATCH)],
    }


def time_snake_conv(gen, counts: dict, errs: dict, frames: int = 86,
                    encoder: bool = False) -> dict:
    """K5 over the 12 DAC decoder residual units (24 launches) for ``frames``
    frames at batch 1 (``encoder``: the 12 encoder units of a 259-frame clip),
    each unit's time printed, beside the plain version (snake + cuDNN fp32,
    TF32 off)."""
    import torch

    from zonos_tpu_torch.kernels.snake_conv import snake_conv1d_plain, snake_residual_unit

    ms = plain_ms = host_ms = bound = 0.0
    bound_ops = bound_bytes = 0.0
    units = []
    shapes = encoder_unit_shapes() if encoder else residual_unit_shapes(frames)
    for C, T, dil in shapes:
        p = _unit_params(gen, C)
        x = torch.randn((1, T, C), generator=gen, device="cuda")
        unit_ms, unit_host = device_ms(lambda: snake_residual_unit(p, x, dil), calls=5)
        ms += unit_ms
        host_ms += unit_host

        def plain_unit():
            y = snake_conv1d_plain(x, p["alpha1"], p["conv1"]["w"], p["conv1"]["b"], dil)
            return snake_conv1d_plain(y, p["alpha2"], p["conv2"]["w"], p["conv2"]["b"], 1, x)

        unit_plain = device_ms(plain_unit, calls=5)[0]
        plain_ms += unit_plain
        unit_bound = 0.0
        for kk, extra in ((7, 0), (1, T * C)):  # second conv also reads the residual
            f = 2 * T * C * C * kk
            b = 4 * (2 * T * C + kk * C * C + 2 * C + extra)
            bound_ops += f / FP32_FLOPS_PER_S
            bound_bytes += b / HBM_BYTES_PER_S
            unit_bound += max(f / FP32_FLOPS_PER_S, b / HBM_BYTES_PER_S)
        bound += unit_bound
        units.append({"C": C, "T": T, "dilation": dil, "ms": unit_ms, "plain_ms": unit_plain,
                      "bound_ms": unit_bound * 1e3})
        print(f"[time] K5 {'encoder' if encoder else 'decoder'} unit C={C} T={T} dil={dil}: "
              f"{unit_ms * 1e3:.1f} us (plain {unit_plain * 1e3:.1f}, bound "
              f"{unit_bound * 1e6:.1f})", flush=True)
    if encoder:
        return {"shape": f"all 12 DAC encoder residual units (24 launches) of a "
                         f"{ENCODE_FRAMES}-frame clip, batch 1, fp32",
                "ms": ms, "kernel_ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "bound_ms": bound * 1e3,
                "bound_by": "operations" if bound_ops >= bound_bytes else "bytes", "units": units}
    return {
        "name": "snake_conv1d", "id": "K5", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/snake_conv.cu",
        "replaces": "zonos_tpu/ops/pallas_dac.py:47",
        **_launches("snake_conv1d", counts),
        "max_abs_err": errs.get("snake_conv1d"),
        "shape": f"all 12 DAC decoder residual units (24 launches) for {frames} frames, batch 1, fp32",
        "ms": ms,
        "kernel_ms": ms,
        "host_ms": host_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound * 1e3,
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "units": units,
        "more": [] if frames != 86 else [time_snake_conv(gen, counts, errs, encoder=True)],
    }


def time_fused_sample(gen, B: int, V: int, warps: int | None = None) -> dict:
    """K3 at default sampling on [B, 9, V] beside the plain version.  The same
    operands every call: on the decode path the step writes the logits and
    the noise just before K3, so they come from L2.  ``warps``: rows a CTA,
    launched through the warp route's C entry point in place of the
    wrapper's plan (``--sweep``), None for the wrapper."""
    from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain

    logits, noise, _ = k3_operands(gen, B, V)
    kw = K3_POINTS[0][1]
    if warps is None:
        def kernel():
            fused_sample(logits, noise, **kw)
    else:
        import torch

        from zonos_tpu_torch.kernels import sampling as k3
        from zonos_tpu_torch.kernels._build import check, library

        lib = library("sampling", k3._SIGNATURES)
        out = torch.empty((B, 9), dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def kernel():
            check(lib.zt_fused_sample_warp(logits.data_ptr(), noise.data_ptr(), out.data_ptr(),
                                           B * 9, V, warps, kw["temperature"],
                                           kw["linear"], kw["conf"], kw["quad"], kw["min_p"],
                                           stream), "fused_sample sweep")
    n = B * 9 * V
    # ~21 operations an entry: the scale, two exp-sum passes, the log, entropy, the
    # reshaping and the race
    return {"shape": f"logits/noise [{B},9,{V}] fp32, default sampling",
            **_times(kernel, lambda: fused_sample_plain(logits, noise, **kw)),
            **_bound(21.0 * n, 8.0 * n + 8.0 * B * 9)}


def time_gemm_train(gen, name: str, M: int, per_step: int) -> dict:
    """G1 on the flagship weight ``name`` at a training step's ``M`` rows
    (:func:`time_gemm`), with the autograd route's backward beside it
    (``gemm_backward``: dX and dW by the plain version's fp32 products)."""
    import torch

    from zonos_tpu_torch.kernels.gemm import gemm_backward

    din, dout = FLAGSHIP_WEIGHTS[name]
    row = time_gemm(gen, f"{name}, a training step's rows", din, dout, M)
    x = torch.randn((M, din), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((din, dout), generator=gen, device="cuda") / din ** 0.5).bfloat16()
    dy = torch.randn((M, dout), generator=gen, device="cuda").bfloat16()
    return {**row, "backward_ms": device_ms(lambda: gemm_backward(x, w, dy), 3, 7)[0],
            "backward": "dX and dW: torch.matmul of the bf16 values in fp32, rounded to bf16",
            "launches_per_train_step": per_step}


def time_row_norm_train(gen, rows: int, per_step: int) -> dict:
    """N1's LayerNorm at a training step's rows (:func:`time_row_norm`), with
    the autograd route's backward (``norm_backward``: the plain version
    recomputed and differentiated for x, the scale and the bias)."""
    import torch

    from zonos_tpu_torch.kernels.row_norm import norm_backward

    d = 2048
    x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    bias = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    dy = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
    return {**time_row_norm(gen, rows, d),
            "backward_ms": device_ms(lambda: norm_backward(x, scale, bias, 1e-5, False, dy))[0],
            "backward": "the plain LayerNorm recomputed and differentiated (x, scale, bias)",
            "launches_per_train_step": per_step}


def time_ssd_train(gen, L: int, per_step: int) -> dict:
    """K6 at the hybrid training step's shape (2 rows of L, the flagship
    widths, no initial state) with the autograd route's backward
    (``ssd_backward``: the plain chunked formulation recomputed and
    differentiated for x, dt, A, B, C, D)."""
    import torch

    from zonos_tpu_torch.kernels.ssd import ssd_backward

    args = ssd_inputs(gen, TRAIN_BATCH, L)[:6]
    upstream = (torch.randn(args[0].shape, generator=gen, device="cuda"),
                torch.randn((TRAIN_BATCH, SSM_H, SSM_P, SSM_N), generator=gen, device="cuda"))
    return {**time_ssd_chunked(gen, TRAIN_BATCH, L),
            "backward_ms": device_ms(lambda: ssd_backward(args, *upstream,
                                                          (True,) * 6 + (False,)), 3, 7)[0],
            "backward": "the plain chunked formulation recomputed and differentiated",
            "launches_per_train_step": per_step}


def phase_timings(gen, counts: dict, errs: dict, prefill_len: int, card: str,
                  train: dict) -> list[dict]:
    """``counts`` maps each main path to its launch counts; ``prefill_len`` is
    the hybrid batch-1 prefill's length (K6's main-path shape); ``train``
    the training phases' statistics (their rows, lengths and launches a
    step), whose shapes get rows of their own under ``"more"``."""
    import torch

    trained = train["transformer"]["launches_per_step"]

    out = [time_decode_attention(gen, key, counts, errs) for key in ("K1", "K2")]
    out.append({
        "name": "fused_sample", "id": "K3", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/sampling.cu",
        "replaces": "zonos_tpu/ops/pallas_kernels.py:232",
        **_launches("fused_sample", counts),
        "max_abs_err": errs["fused_sample"],
        **time_fused_sample(gen, *K3_TIMED[0]),
        "library_ms": None,
        "more": [time_fused_sample(gen, B, V) for B, V in K3_TIMED[1:]],
    })
    out.append(time_snake_conv(gen, counts, errs))

    main_shape = time_ssd_chunked(gen, 2, prefill_len)
    out.append({
        "name": "ssd_chunked", "id": "K6", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/ssd_chunked.cu",
        "replaces": "zonos_tpu/ops/pallas_ssm.py:167",
        **_launches("ssd_chunked", counts),
        "max_abs_err": errs["ssd_chunked"],
        **main_shape,
        "library_ms": None,
        "library_why": "no single PyTorch call computes a chunked (or any) selective scan",
        "more": [time_ssd_chunked(gen, rows, L) for rows, L in K6_TIMED[1:]]
                + [time_ssd_train(gen, train["hybrid"]["L"],
                                  train["hybrid"]["launches_per_step"]["ssd_chunked"])],
    })
    main_shape = time_fused_state_step(gen, 128, torch.float32)
    out.append({
        "name": "fused_state_step", "id": "K7", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/ssm_state.cu",
        "replaces": "zonos_tpu/ops/pallas_state.py:49",
        **_launches("fused_state_step", counts),
        "max_abs_err": errs["fused_state_step"],
        **main_shape,
        "library_ms": None,
        "more": [time_fused_state_step(gen, BH, dtype)
                 for BH, dtype in ((128, torch.bfloat16), (128, torch.float8_e4m3fn),
                                   (1024, torch.float32), (1024, torch.bfloat16),
                                   (1024, torch.float8_e4m3fn))],
    })
    for mode in ("int8", "int4"):
        out.append({
            "name": f"fused_state_step_{mode}", "id": f"K7 {mode}", "route": "cuda",
            "source": "zonos_tpu_torch/csrc/ssm_state.cu",
            "replaces": "zonos_tpu/ops/pallas_state.py:49",
            **_launches(f"fused_state_step_{mode}", counts),
            "max_abs_err": errs[f"fused_state_step_{mode}"],
            **time_fused_state_step_quant(gen, 128, mode),
            "library_ms": None,
            "library_why": "no single PyTorch call dequantizes, updates, reduces and requantizes "
                           "the state",
            "more": [time_fused_state_step_quant(gen, 1024, mode)],
        })
    out.append({
        "name": "fused_layer_tail", "id": "K4", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/layer_tail.cu",
        "replaces": "zonos_tpu/ops/pallas_decode.py:94",
        **_launches("fused_layer_tail", counts),
        "max_abs_err": errs["fused_layer_tail"],
        **time_layer_tail(gen, 2),
        "library_ms": None,
        "more": [time_layer_tail(gen, B2) for B2 in (8, 128)],
    })
    out.append({
        "name": "int4_matmul", "id": "K8", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "zonos_tpu/ops/pallas_kernels.py:294",
        **_launches("int4_matmul", counts),
        "max_abs_err": errs["int4_matmul"],
        **time_int4_matmul(gen, "w1", *FLAGSHIP_WEIGHTS["w1"], 2),
        "more": [time_int4_matmul(gen, name, din, dout, M)
                 for M in (2, 8) for name, (din, dout) in FLAGSHIP_WEIGHTS.items()
                 if (name, M) != ("w1", 2)]
                + [time_int4_matmul(gen, "w1", *FLAGSHIP_WEIGHTS["w1"], 64)],
    })
    out.append({
        "name": "gemm", "id": "G1", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/gemm.cu",
        "replaces": "zonos_tpu/models/backbone.py:46 (no TPU kernel: XLA's dot in matmul_w)",
        **_launches("gemm", counts),
        "max_abs_err": errs["gemm"],
        **time_gemm(gen, "w2", *FLAGSHIP_WEIGHTS["w2"], 2),
        "more": [time_gemm(gen, name, din, dout, M)
                 for M in GEMM_TIMED_ROWS for name, (din, dout) in FLAGSHIP_WEIGHTS.items()
                 if (name, M) != ("w2", 2)]
                + [time_gemm(gen, name, *FLAGSHIP_WEIGHTS[name], M, int8=True)
                   for M in (2, 142) for name in ("wqkv", "heads")]
                + [time_gemm_train(gen, name, train["transformer"]["rows"], trained["gemm"])
                   for name in ("w1", "w2")],
    })
    out.append({
        "name": "gemm_norm", "id": "G1+N1", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/gemm.cu (zonos_tpu_torch/csrc/row_stats.cuh)",
        "replaces": "zonos_tpu/ops/norms.py:16 and zonos_tpu/models/backbone.py:46 (no TPU "
                    "kernel: XLA's reductions and dot)",
        **_launches("gemm_norm", counts),
        "max_abs_err": errs["gemm_norm"],
        **time_norm_fold(gen, "w1", *FLAGSHIP_WEIGHTS["w1"], 2),
        "more": [time_norm_fold(gen, "wqkv", *FLAGSHIP_WEIGHTS["wqkv"], 2),
                 time_norm_fold(gen, "wqkv", *FLAGSHIP_WEIGHTS["wqkv"], 2, weight="int8"),
                 time_norm_fold(gen, "in_proj", *HYBRID_WEIGHTS["in_proj"], 2,
                                dtype=torch.float32, rms=True),
                 time_norm_fold(gen, "out_proj", *HYBRID_WEIGHTS["out_proj"], 2, rms=True)]
                + fold_table(gen, card),
    })
    out.append({
        "name": "int4_matmul_norm", "id": "K8+N1", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/int4_matmul.cu (zonos_tpu_torch/csrc/row_stats.cuh)",
        "replaces": "zonos_tpu/ops/pallas_kernels.py:294 and zonos_tpu/ops/norms.py:16",
        **_launches("int4_matmul_norm", counts),
        "max_abs_err": errs["int4_matmul_norm"],
        **time_norm_fold(gen, "w1", *FLAGSHIP_WEIGHTS["w1"], 2, weight="int4"),
        "more": [time_norm_fold(gen, "wqkv", *FLAGSHIP_WEIGHTS["wqkv"], 2, weight="int4")],
    })
    out.append({
        "name": "row_norm", "id": "N1", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/row_norm.cu",
        "replaces": "zonos_tpu/ops/norms.py:16 (no TPU kernel: XLA's reductions)",
        **_launches("row_norm", counts),
        "max_abs_err": errs["row_norm"],
        **time_row_norm(gen, 2),
        "more": [time_row_norm(gen, rows) for rows in (128, 142, 64 * 142)]
                + [time_row_norm_train(gen, train["transformer"]["rows"], trained["row_norm"])],
    })
    return out


def k8_breakdown(gen, card: str, calls: int = 40) -> None:
    """Where a K8 call's device time goes, at M = 2 on each flagship weight
    (default split, L2 cold): the per-call time as ``device_ms`` reads it
    beside the kernel's and the counters' memset's own durations from
    torch.profiler (CUPTI), and the timing harness's floor (a one-element
    add)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels.int4_matmul import int4_matmul

    one = torch.zeros(1, device="cuda")
    print(f"[sweep] timing floor, one-element add: {device_ms(lambda: one.add_(1))[0] * 1e3:.2f} us "
          f"({card})", flush=True)
    for name, (din, dout) in FLAGSHIP_WEIGHTS.items():
        sets = []
        for _ in range(2 + int(64e6 // (din * dout // 2))):  # over the 50 MB L2
            w = int4_weight(gen, din, dout)
            sets.append((torch.randn((2, din), generator=gen, device="cuda").bfloat16(),
                         w["q4"], w["s4"]))
        cycle = itertools.cycle(sets)
        ms = device_ms(lambda: int4_matmul(*next(cycle)))[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                int4_matmul(*next(cycle))
            torch.cuda.synchronize()
        parts = {"kernel": 0.0, "memset": 0.0}
        for e in prof.key_averages():
            key = "kernel" if "int4_matmul" in e.key else "memset" if "Memset" in e.key else None
            if key is not None:
                parts[key] += e.self_device_time_total / calls
        print(f"[sweep] K8 {name} M=2: {ms * 1e3:.2f} us a call; kernel {parts['kernel']:.2f} us, "
              f"memset {parts['memset']:.2f} us (CUPTI; {card})", flush=True)


def k4_breakdown(gen, card: str, calls: int = 20) -> None:
    """Where a K4 call's device time goes at B2 = 2, 8 and 128 (default
    splits, two weight sets alternating, L2 cold): each launch's own duration
    (memset, the wo, w1 and w2 passes, the LayerNorm) from torch.profiler
    (CUPTI), beside the per-call time as ``device_ms`` reads it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels.layer_tail import fused_layer_tail

    names = {"tail_pass_kernel<0": "wo", "tail_layer_norm": "LayerNorm",
             "tail_pass_kernel<1": "w1", "tail_pass_kernel<2": "w2", "Memset": "memset"}
    for B2 in (2, 8, 128):
        cycle = itertools.cycle([layer_tail_args(gen, B2) for _ in range(2)])
        ms = device_ms(lambda: fused_layer_tail(*next(cycle)))[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fused_layer_tail(*next(cycle))
            torch.cuda.synchronize()
        parts = dict.fromkeys(names.values(), 0.0)
        for e in prof.key_averages():
            key = next((v for k, v in names.items() if k in e.key), None)
            if key is not None:
                parts[key] += e.self_device_time_total / calls
        print(f"[sweep] K4 B2={B2}: {ms * 1e3:.2f} us a call; " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()) + f" us (CUPTI; {card})", flush=True)


def phase_sweep(gen, card: str) -> None:
    """``python3 chip_smoke.py --sweep``: how K8's and K4's default splits
    were chosen.  K8 on each weight at M = 2 and 8 for 1 to 32 splits of the
    packed rows (one wave of CTAs ends where splits x 128-column tiles pass
    the SM count); K4 at B2 = 2, 8 and 128 for a target of half, one and two
    CTAs per SM; then the sweeps of K7, K2, K1, K5, K3 and K6.  Device times
    per call, L2 cold."""
    from zonos_tpu_torch.kernels._build import sm_count
    from zonos_tpu_torch.kernels.int4_matmul import split_count

    sms = sm_count(0)
    k8_breakdown(gen, card)
    k4_breakdown(gen, card)
    for M in (2, 8):
        for name, (din, dout) in {**FLAGSHIP_WEIGHTS, **HYBRID_WEIGHTS}.items():
            row, r = {}, {}
            for n in (1, 2, 3, 4, 6, 8, 12, 16, 32):
                n = split_count(din, dout, sms, n)  # as the kernel would run it
                if n not in row:
                    r = time_int4_matmul(gen, name, din, dout, M, n_split=n)
                    row[n] = r["ms"] * 1e3
            print(f"[sweep] K8 {name} M={M}, us by splits: "
                  + ", ".join(f"{n}: {us:.2f}" for n, us in row.items())
                  + f" (default {split_count(din, dout, sms)}; bound "
                  f"{r['bound_ms'] * 1e3:.2f} us, bf16 torch.matmul "
                  f"{r['library_ms'] * 1e3:.1f} us; {card})", flush=True)
    for B2 in (2, 8, 128):
        row = {t: time_layer_tail(gen, B2, target_ctas=t)["ms"] * 1e3
               for t in (sms // 2, sms, 2 * sms)}
        print(f"[sweep] K4 B2={B2}, us by target CTAs: "
              + ", ".join(f"{t}: {us:.1f}" for t, us in row.items())
              + f" (default {sms}, the SM count; {card})", flush=True)
    k7_sweep(gen, card)
    k2_sweep(gen, card)
    k1_sweep(gen, card)
    k5_sweep(gen, card)
    k3_sweep(gen, card)
    k6_sweep(gen, card)


def k6_sweep(gen, card: str) -> None:
    """K6 at K6_TIMED over every plan the kernel takes at the flagship widths
    (column groups of warps, cluster size), launched through the C entry point,
    with how many clusters of each fit on the card (how ``ssd_plan``'s defaults
    were chosen); device us per call."""
    import ctypes

    from zonos_tpu_torch.kernels import ssd as k6
    from zonos_tpu_torch.kernels._build import sm_count

    lib = k6._library(0)
    for rows, L in K6_TIMED:
        args = ssd_inputs(gen, rows, L)[:6]
        default = k6.ssd_plan(rows, L, SSM_H, 1, SSM_P, SSM_N, sm_count(0))
        row = []
        for groups, cluster in itertools.product((1, 2, 4, 8), (1, 2, 4, 8)):
            if lib.zt_ssd_chunked_smem(SSM_H, 1, SSM_P, SSM_N, groups, cluster) < 0:
                continue  # a plan the kernel refuses
            plan = k6.SsdPlan(groups, cluster)
            fit = ctypes.c_int(0)
            check_rc = lib.zt_ssd_chunked_max_active_clusters(
                SSM_H, 1, SSM_P, SSM_N, groups, cluster, ctypes.byref(fit))
            if check_rc != 0:
                fail(f"K6 plan {plan}: occupancy query {check_rc}")
            us = device_ms(lambda: k6.launch(*args, None, plan), reps=5)[0] * 1e3
            warps = -(-SSM_P // 16) * groups
            row.append(f"g{groups} c{cluster} ({warps}w, {fit.value} fit) {us:.2f}")
        print(f"[sweep] K6 x [{rows},{L},{SSM_H},{SSM_P}], us by groups / cluster: "
              + "; ".join(row) + f" (default g{default.groups} c{default.cluster}; {card})",
              flush=True)


def k3_sweep(gen, card: str) -> None:
    """K3's warp route at V 1152, batch 1 and 64, for 1, 2, 4 and 8 rows a CTA
    (how ``WARPS_PER_CTA`` was chosen); device us per call."""
    from zonos_tpu_torch.kernels.sampling import WARPS_PER_CTA

    for B in (1, B64_BATCH):
        row = {w: time_fused_sample(gen, B, 1152, warps=w)["ms"] * 1e3 for w in (1, 2, 4, 8)}
        print(f"[sweep] K3 [{B},9,1152], us by rows a CTA: "
              + ", ".join(f"{w}: {us:.2f}" for w, us in row.items())
              + f" (default {WARPS_PER_CTA}; {card})", flush=True)


def k2_sweep(gen, card: str) -> None:
    """K2 (bf16, q [2,1,16,128], batch 1 with CFG) over cache lengths, launched
    through the C entry point with each split the CTAs compute from the
    length: a CTA for every 16, 32, 64 or 128 rows (``min_rows``; one CTA up
    to twice that), in a grid of just the CTAs used and in the band's grid of
    8 (the idle CTAs' cost), each with the shared memory of its own chunk;
    then the band's own launch (the shared memory of the band's longest
    chunk): how ``CHUNK_ROWS`` was chosen and what the band plan costs;
    device us per call, L2 cold."""
    import torch

    from zonos_tpu_torch.kernels import decode_attention as da
    from zonos_tpu_torch.kernels._build import check, library

    lib = library("decode_attention", da._SIGNATURES)

    def launch(q, k, v, rows, length, n, min_rows, band=None):
        out = torch.empty_like(q)
        lo, hi, chunk_max = length, length, da.rank_rows(length, n, min_rows)[1]
        if band is not None:
            plan = da.band_plan("K2", band, q.shape[0] * k.shape[1], k.shape[2], False)
            lo, hi, chunk_max = plan.lo, plan.hi, plan.chunk_max
        check(lib.zt_decode_attention_single(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], k.shape[1],
            q.shape[2] // k.shape[1], k.shape[2], rows.data_ptr(), lo, hi, n, n, chunk_max,
            min_rows, da.attention_scale(128), torch.cuda.current_stream().cuda_stream),
            "K2 sweep")
        return out

    sets = [tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((2, 1, 16, 128), (2, 4, 2048, 128), (2, 4, 2048, 128)))
            for _ in range(8)]
    cycle = itertools.cycle(sets)
    for length in (16, 32, 48, 64, 96, 128, 192, 256):
        rows, band = on_card(length)
        row = {}
        for min_rows in (16, 32, 64, 128):
            used, chunk = da.rank_rows(length, da.MAX_CLUSTER, min_rows)
            for n in sorted({used, da.MAX_CLUSTER}):
                us = device_ms(lambda: launch(*next(cycle), rows, length, n, min_rows))[0] * 1e3
                row[f"{min_rows} ({used} of {n} CTAs)"] = us
        row["the band's launch"] = device_ms(lambda: launch(
            *next(cycle), rows, length, da.MAX_CLUSTER, da.CHUNK_ROWS, band))[0] * 1e3
        print(f"[sweep] K2 bf16 length {length}, us by rows a CTA: " + ", ".join(
            f"{k}: {us:.2f}" for k, us in row.items())
            + f" (default {da.CHUNK_ROWS} in a grid of {da.MAX_CLUSTER}; {card})", flush=True)


def k1_sweep(gen, card: str) -> None:
    """K1 over cache lengths 512, 1000, 2000 and 4000 at batch 1 with CFG
    (bf16, q [2,1,16,128]) and batch 64 with CFG (f8 with the held-out row, q
    [128,1,16,128]) for clusters of 1, 2, 4, 8 and 16 CTAs, launched through the C
    entry points, and how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``): how ``grid_cap`` was chosen; device
    us per call, L2 cold."""
    import torch

    from zonos_tpu_torch.kernels import decode_attention as da
    from zonos_tpu_torch.kernels._build import check, library, sm_count

    lib = library("decode_attention", da._SIGNATURES)
    scale = da.attention_scale(128)

    def launch(q, k, v, k_new, v_new, rows, length, n, chunk):
        out = torch.empty_like(q)
        B, _, H, _ = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream().cuda_stream
        plan = (rows.data_ptr(), length, length, n, n, chunk, da.ONE_CTA_ROWS, scale, stream)
        if k_new is None:
            rc = lib.zt_flash_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), B, Hkv, H // Hkv, S, *plan)
        else:
            rc = lib.zt_flash_decode_attention_q(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), 0,
                                                 0, k_new.data_ptr(), v_new.data_ptr(),
                                                 out.data_ptr(), B, Hkv, H // Hkv, S, *plan)
        check(rc, "K1 sweep")
        return out

    S = 4096
    b1 = [tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                for shape in ((2, 1, 16, 128), (2, 4, S, 128), (2, 4, S, 128))) + (None, None)
          for _ in range(8)]
    b64 = []
    for _ in range(2):  # 2 x 537 MB: over the 50 MB L2
        k, v, _, _ = quantized_cache(gen, "f8", 2 * B64_BATCH, 4, S)
        q, k_new, v_new = held_out_inputs(gen, 2 * B64_BATCH)
        b64.append((q, k, v, k_new, v_new))
    for label, sets, storage in (("batch 1, bf16", b1, torch.bfloat16),
                                 ("batch 64, f8", b64, torch.float8_e4m3fn)):
        cycle = itertools.cycle(sets)
        pairs = sets[0][0].shape[0] * 4
        for length in (512, 1000, 2000, 4000):
            rows, band = on_card(length)
            row = {}
            for n in (1, 2, 4, 8, 16):
                used, chunk = da.rank_rows(length, n, da.ONE_CTA_ROWS)
                us = device_ms(lambda: launch(*next(cycle), rows, length, n, chunk))[0] * 1e3
                fits = da.max_active_clusters(storage, 4, n, chunk)
                row[f"{used} CTAs of {chunk}"] = f"{us:.2f} ({fits} clusters fit)"
            plan = da.band_plan("K1", band, pairs, S, False, sm_count(0))
            print(f"[sweep] K1 {label} length {length}, us by cluster: " + ", ".join(
                f"{k}: {v}" for k, v in row.items())
                + f" (default {plan.n} ranks on {plan.grid} CTAs; {card})", flush=True)


def k5_sweep(gen, card: str, frames: int = 86) -> None:
    """K5 with each of its tiles at each DAC width (the dilation-9 unit's k = 7
    conv and its k = 1 conv, batch 1, 86 frames), launched through the C entry
    point and held against the plain version (1e-4 x max|ref|): how
    ``conv_plan`` and ``TILE_COST`` were chosen; device us per call."""
    import torch

    from zonos_tpu_torch.kernels import snake_conv as k5
    from zonos_tpu_torch.kernels._build import check, library, sm_count

    lib = library("snake_conv", k5._SIGNATURES)

    def launch(x, alpha, w_kio, b, dil, res, tile):
        B, T, C = x.shape
        y = torch.empty_like(x)
        check(lib.zt_snake_conv1d(x.data_ptr(), alpha.data_ptr(), w_kio.data_ptr(), b.data_ptr(),
                                  res.data_ptr() if res is not None else None, y.data_ptr(),
                                  B, T, C, C, w_kio.shape[0], dil, tile,
                                  torch.cuda.current_stream().cuda_stream), "K5 sweep")
        return y

    for C, T, dil in residual_unit_shapes(frames):
        if dil != 9:
            continue
        p = _unit_params(gen, C)
        x = torch.randn((1, T, C), generator=gen, device="cuda")
        for alpha, conv, d, res in ((p["alpha1"], p["conv1"], dil, None),
                                    (p["alpha2"], p["conv2"], 1, x)):
            w_kio = conv["w"].permute(2, 1, 0).contiguous()
            ref = k5.snake_conv1d_plain(x, alpha, conv["w"], conv["b"], d, res)
            row = {}
            for tile, (tt, tc) in enumerate(k5.TILES):
                err = float((launch(x, alpha, w_kio, conv["b"], d, res, tile) - ref).abs().max())
                if not err <= 1e-4 * float(ref.abs().max()):
                    fail(f"K5 sweep tile {tt}x{tc} C={C} T={T} k={w_kio.shape[0]}: err {err}")
                us = device_ms(lambda: launch(x, alpha, w_kio, conv["b"], d, res, tile),
                               calls=5)[0] * 1e3
                row[f"{tt}x{tc} ({-(-T // tt) * -(-C // tc)} CTAs)"] = us
            default = k5.TILES[k5.conv_plan(T, C, C, w_kio.shape[0], d, sm_count(0))]
            flops = 2.0 * T * C * C * w_kio.shape[0]
            print(f"[sweep] K5 C={C} T={T} k={w_kio.shape[0]} dil={d}, us by tile: " + ", ".join(
                f"{k}: {us:.1f}" for k, us in row.items())
                + f" (default {default[0]}x{default[1]}; fp32 bound "
                f"{flops / FP32_FLOPS_PER_S * 1e6:.1f} us; {card})", flush=True)


def k1_breakdown(gen, card: str, calls: int = 40) -> None:
    """Where a K1 call's device time goes at its four timed shapes (batch 1
    with CFG at length 2000 over bf16, f8 and int8 caches; batch 64 with CFG
    over f8): each kernel's own duration per call from torch.profiler
    (CUPTI), beside the per-call time as ``device_ms`` reads it, and the
    timing harness's floor (a one-element add)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels.decode_attention import (
        flash_decode_attention,
        flash_decode_attention_held_out,
    )

    one = torch.zeros(1, device="cuda")
    print(f"[times] timing floor, one-element add: {device_ms(lambda: one.add_(1))[0] * 1e3:.2f} "
          f"us ({card})", flush=True)
    for label, storage, B in (("bf16", None, 2), ("f8", "f8", 2), ("int8", "int8", 2),
                              ("f8 batch 64", "f8", 2 * B64_BATCH)):
        sets = []
        for _ in range(8 if B == 2 else 2):
            if storage is None:
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                           for shape in ((B, 1, 16, 128), (B, 4, 2048, 128), (B, 4, 2048, 128)))
                sets.append(lambda q=q, k=k, v=v, at=on_card(2000):
                            flash_decode_attention(q, k, v, *at))
            else:
                k, v, ks, vs = quantized_cache(gen, storage, B)
                q, k_new, v_new = held_out_inputs(gen, B)
                pos_t, band = on_card(1999, held_out=True)
                sets.append(lambda a=(q, k, v, k_new, v_new, pos_t, ks, vs), b=band:
                            flash_decode_attention_held_out(*a, band=b))
        cycle = itertools.cycle(sets)
        ms = device_ms(lambda: next(cycle)())[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                next(cycle)()
            torch.cuda.synchronize()
        parts: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("<")[0].split("(")[0]
                parts[name] = parts.get(name, 0.0) + e.self_device_time_total / calls
        print(f"[times] K1 {label}: {ms * 1e3:.2f} us a call; " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()) + f" us (CUPTI; {card})", flush=True)


def phase_times(gen, card: str, port: bool) -> None:
    """``python3 chip_smoke.py --times [--port DIR]``: the timed rows of K1,
    K2, K5, K3 and K6 (no checks, no main paths, launches 0) and K1's, K3's
    and K6's breakdowns, one JSON line each.  With ``--port DIR`` (``port``) the port
    is imported from DIR, a checkout of another commit (its kernels built
    from its own sources into its own ``build/``): run it beside this tree's
    in turns to compare two commits on one card."""
    k3_shapes = k3_timed_shapes(gen, card, port)
    k1_breakdown(gen, card)
    k3_breakdown(gen, card, k3_shapes)
    k6_breakdown(gen, card)
    for entry in (time_decode_attention(gen, "K1", {}, {}), time_decode_attention(gen, "K2", {}, {}),
                  time_snake_conv(gen, {}, {})):
        print(json.dumps({"times": entry, "card": card}), flush=True)
    for B, V in k3_shapes:
        print(json.dumps({"times": {"id": "K3", **time_fused_sample(gen, B, V)}, "card": card}),
              flush=True)
    for rows, L in K6_TIMED:
        print(json.dumps({"times": {"id": "K6", **time_ssd_chunked(gen, rows, L)}, "card": card}),
              flush=True)


def k6_breakdown(gen, card: str, calls: int = 40) -> None:
    """K6's own duration a launch from torch.profiler (CUPTI) at K6_TIMED, beside
    the per-call time as ``device_ms`` reads it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels.ssd import ssd_chunked

    for rows, L in K6_TIMED:
        args = ssd_inputs(gen, rows, L)[:6]
        ms = device_ms(lambda: ssd_chunked(*args))[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ssd_chunked(*args)
            torch.cuda.synchronize()
        own = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_chunked" in e.key)
        print(f"[times] K6 x [{rows},{L},{SSM_H},{SSM_P}]: {ms * 1e3:.2f} us a call, the "
              f"kernel's own {own / calls:.2f} us (CUPTI; {card})", flush=True)


def k3_timed_shapes(gen, card: str, port: bool) -> list[tuple[int, int]]:
    """K3_TIMED; under ``--port``, less the CTA route's shapes the other
    checkout's K3 refuses (before this tree's, V 12,288 passed the 48 KB
    default of shared memory), each named on a line of its own.  A refusal of
    this tree's K3, or at a vocabulary on the warp route, stops the run."""
    import torch

    from zonos_tpu_torch.kernels.sampling import fused_sample

    if not port:
        return list(K3_TIMED)
    shapes = []
    for B, V in K3_TIMED:
        logits, noise, _ = k3_operands(gen, B, V)
        try:
            fused_sample(logits, noise, **K3_POINTS[0][1])
            torch.cuda.synchronize()
        except RuntimeError as e:
            if V <= 1152:
                raise
            print(f"[times] K3 [{B},9,{V}]: refused by the checkout under --port ({e}; {card})",
                  flush=True)
            continue
        shapes.append((B, V))
    return shapes


def k3_breakdown(gen, card: str, shapes: list, calls: int = 40) -> None:
    """K3's own duration a launch from torch.profiler (CUPTI) at ``shapes``,
    beside the per-call time as ``device_ms`` reads it (which adds the gaps
    between back-to-back launches); first a one-element add's own duration,
    the floor of any launch (``k1_breakdown`` prints its per-call time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.kernels.sampling import fused_sample

    kw = K3_POINTS[0][1]
    one = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            one.add_(1)
        torch.cuda.synchronize()
    own = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[times] floor, a one-element add's own time: {own / calls:.2f} us (CUPTI; {card})",
          flush=True)
    for B, V in shapes:
        logits, noise, _ = k3_operands(gen, B, V)
        ms = device_ms(lambda: fused_sample(logits, noise, **kw))[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fused_sample(logits, noise, **kw)
            torch.cuda.synchronize()
        own = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "fused_sample" in e.key)
        print(f"[times] K3 [{B},9,{V}]: {ms * 1e3:.2f} us a call, the kernel's own "
              f"{own / calls:.2f} us (CUPTI; {card})", flush=True)


def k7_sweep(gen, card: str) -> None:
    """K7 at its two flagship shapes for slabs of 64 down to 2 state rows,
    launched through the C entry point with each (how ``CTAS_PER_SM`` and
    ``MIN_SLAB_BYTES`` were chosen); device us per call, L2 cold."""
    import torch

    from zonos_tpu_torch.kernels._build import sm_count
    from zonos_tpu_torch.kernels.ssm_state import MAX_SLAB_BYTES, slab_plan

    for BH, dtype in ((128, torch.float32), (1024, torch.float8_e4m3fn)):
        itemsize = torch.empty((), dtype=dtype).element_size()
        row = {}
        for rows in (64, 32, 16, 8, 4, 2):
            if rows * SSM_N * itemsize <= MAX_SLAB_BYTES:
                row[f"{rows} ({BH * -(-SSM_P // rows)} CTAs)"] = \
                    time_fused_state_step(gen, BH, dtype, rows)["ms"] * 1e3
        print(f"[sweep] K7 [{BH},{SSM_P},{SSM_N}] {str(dtype).split('.')[-1]}, us by rows a "
              f"slab: " + ", ".join(f"{k}: {us:.2f}" for k, us in row.items())
              + f" (default {slab_plan(BH, SSM_P, SSM_N, itemsize, sm_count(0))[0]} rows; "
              f"{card})", flush=True)


def main(argv: list[str]) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if argv[:1] == ["--mesh-rank"] and len(argv) == 4:  # a process of [mesh 1x2] / [mesh 2x1]
        sys.path.insert(0, here)
        return mesh_rank(int(argv[1]), argv[2], argv[3])
    port = argv[:1] in (["--times"], ["--profile"]) and argv[1:2] == ["--port"] and len(argv) == 3
    if port:
        here = os.path.abspath(argv[2])
        sys.path.insert(0, here)
        argv = argv[:1]
    if argv not in ([], ["--sweep"], ["--times"], ["--profile"]):
        fail(f"usage: chip_smoke.py [--sweep | --times [--port DIR] | --profile [--port DIR]], "
             f"not {argv}")
    card = phase_device(here)
    import torch

    torch.backends.cudnn.allow_tf32 = False  # fp32 references really in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if argv == ["--sweep"]:
        phase_sweep(gen, card)
    elif argv == ["--times"]:
        phase_times(gen, card, port)
    elif argv == ["--profile"]:
        phase_steady_steps(card)
    if argv:
        return 0
    errs = dict(check_decode_attention(gen))
    errs["fused_sample"] = check_fused_sample(gen)
    errs["snake_conv1d"] = check_snake_conv(gen)
    errs["ssd_chunked"] = check_ssd_chunked(gen)
    errs["fused_state_step"] = check_fused_state_step(gen)
    errs.update({f"fused_state_step_{mode}": err
                 for mode, err in check_fused_state_step_quant(gen).items()})
    check_snake_conv_encoder(gen)
    errs.update(check_decode_attention_quantized(gen))
    check_flash_attention(gen, errs)
    check_attention_grids(gen)
    errs["fused_layer_tail"] = check_layer_tail(gen)
    errs["int4_matmul"] = check_int4_matmul(gen)
    errs["gemm"] = check_gemm(gen)
    errs["row_norm"] = check_row_norm(gen)
    errs["gemm_norm"] = check_gemm_fold(gen)
    errs["int4_matmul_norm"] = check_int4_fold(gen)
    check_autograd(gen)

    from zonos_tpu_torch import DACAutoencoder

    dac = DACAutoencoder(seed=0)
    print(f"[time] kernel checks done {time.perf_counter() - t0:.1f} s after the device check",
          flush=True)
    counts = {}
    audio_codes, counts["encode"] = phase_encode(card, dac)

    graph = {}

    def path(kind, model, batch, expect, new_tokens, **kw):
        counts[kind], prefix = phase_main_path(card, kind, model, dac, batch, expect, new_tokens,
                                               **kw)
        print(f"[time] {kind} path done {time.perf_counter() - t0:.1f} s", flush=True)
        graph[kind] = phase_graph(card, kind, model, prefix, GRAPH_NEW_TOKENS)
        phase_profile(kind, model, prefix, card)
        print(f"[time] {kind} graph and profile done {time.perf_counter() - t0:.1f} s", flush=True)
        return prefix

    model = load_model("transformer")
    prefix = path("transformer", model, 4, TRANSFORMER_KERNELS, TRANSFORMER_NEW_TOKENS)
    counts["prefix transformer"] = phase_prefix(card, "transformer", model, prefix, audio_codes,
                                                PREFIX_KERNELS)
    counts["stream transformer"] = phase_stream(card, model, dac)
    print(f"[time] transformer prefix and stream done {time.perf_counter() - t0:.1f} s",
          flush=True)
    counts["serve transformer"], served = phase_serve(card, model, dac)
    print(f"[time] serve transformer done {time.perf_counter() - t0:.1f} s", flush=True)
    phase_cobatch(card, model)
    print(f"[time] cobatch done {time.perf_counter() - t0:.1f} s", flush=True)
    with temporary_models_dir() as models_dir:
        counts["checkpoint transformer"] = phase_checkpoint(card, "transformer", model, models_dir)
        phase_speaker(card, model, models_dir)
        phase_serve_speakers(card, served, model)
        served.close()
        counts["quickstart"] = phase_quickstart(card, models_dir)
        counts["apps"] = phase_apps(card, models_dir)
        print(f"[time] apps done {time.perf_counter() - t0:.1f} s", flush=True)
    phase_ecapa(card)
    print(f"[time] checkpoint, speaker, quick start and ECAPA done "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    quantize_model("transformer", model, "int8")  # the bf16 model, quantized in place
    path("transformer int8", model, 4, INT8_KERNELS, TRANSFORMER_NEW_TOKENS, batch_kv="int8")
    phase_cobatch(card, model, "[cobatch int8]", COBATCH_INT8_BATCHES, full=False)
    phase_profile_batch64(model, card)
    print(f"[time] transformer int8 b64 profile done {time.perf_counter() - t0:.1f} s", flush=True)
    counts["serve transformer int8"] = phase_serve_int8(card, model)
    print(f"[time] serve transformer int8 done {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    model = load_model("transformer")  # a fresh seed-0 model
    quantize_model("transformer", model, "int4")
    path("transformer int4", model, 4, INT4_KERNELS, TRANSFORMER_NEW_TOKENS, batch_kv="f8",
         forbid=("fused_layer_tail",))
    del model
    torch.cuda.empty_cache()
    model = load_model("hybrid")
    prefix = path("hybrid", model, 8, HYBRID_KERNELS, MAX_NEW_TOKENS)
    phase_cobatch(card, model, "[cobatch hybrid]", COBATCH_HYBRID_BATCHES, full=False,
                  trace=True)
    counts["prefix hybrid"] = phase_prefix(card, "hybrid", model, prefix, audio_codes,
                                           PREFIX_KERNELS + ("ssd_chunked", "fused_state_step"))
    with temporary_models_dir() as models_dir:
        counts["checkpoint hybrid"] = phase_checkpoint(card, "hybrid", model, models_dir)
    print(f"[time] hybrid checkpoint done {time.perf_counter() - t0:.1f} s", flush=True)
    quantize_model("hybrid", model, "int4")
    counts["hybrid int4"] = phase_hybrid_quantized(card, model, prefix, HYBRID_INT4_KERNELS)
    graph["hybrid int4"] = phase_graph(card, "hybrid int4", model, prefix,
                                       HYBRID_INT4_NEW_TOKENS)
    print(f"[time] hybrid int4 path done {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    model = load_model("hybrid")  # a fresh seed-0 model
    quantize_model("hybrid", model, "int8")
    counts["hybrid int8"] = phase_hybrid_int8(card, model)
    print(f"[time] hybrid int8 path done {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    train = {}
    model = load_model("transformer")  # a fresh seed-0 model
    counts["train transformer"], train["transformer"] = phase_train_transformer(card, model)
    counts["train lora"], train["lora"] = phase_train_lora(card, model)
    del model
    torch.cuda.empty_cache()
    print(f"[time] train transformer and lora done {time.perf_counter() - t0:.1f} s", flush=True)
    counts["train hybrid"], train["hybrid"] = phase_train_hybrid(card)
    counts["train cli"] = phase_train_cli(card)
    print(f"[time] train hybrid and cli done {time.perf_counter() - t0:.1f} s", flush=True)
    counts["mesh 1x1"] = phase_mesh_1x1(card)
    counts["mesh 1x2"] = phase_mesh_pair(card, "1x2")
    counts["mesh 2x1"] = phase_mesh_pair(card, "2x1")
    print(f"[time] meshes done {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"graph": graph, "train": train, "card": card}), flush=True)
    kernels = phase_timings(gen, counts, errs, prefill_len=prefix.shape[1] + 1, card=card,
                            train=train)
    for entry in kernels:  # one JSON line per kernel, each with the card it ran on
        print(json.dumps({**entry, "card": card}), flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device check", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
