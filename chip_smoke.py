#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zonos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles every kernel under zonos_tpu_torch/csrc/ (one nvcc per
   source, in parallel) and prints the build time.
3. kernels: holds each kernel against its plain PyTorch version on the same
   inputs at flagship shapes, with the tolerance stated beside each check.
4. main path: text -> codes -> 44.1 kHz wav on the full-width flagship
   transformer (random bf16 weights from a seed) and the full DAC (random
   fp32), at batch 1 (twice, same seed: identical codes) and at batch 4;
   launch counts are zeroed just before and read just after, and every
   kernel of the path must have launched.
5. timings: each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, median of CUDA-event
   timings; prints the ``{"kernels": [...]}`` line.

The last line of stdout is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
MAX_NEW_TOKENS = 430  # ~5 s of audio at 86.13 frames/s
FRAMES_PER_S = 44100 / 512
SLEEP_CYCLES = 60_000_000  # ~30 ms at the H100's clock: longer than queueing a timed batch
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis is wonderful.",
    "How are you today?",
    "She sells seashells by the seashore.",
]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_ulp(x: float) -> float:
    import math

    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


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


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one NVIDIA card")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import zonos_tpu_torch
    except ImportError as e:
        fail(f"cannot import the port ({e}): run this script from the repository's root")
    if os.path.dirname(os.path.dirname(os.path.abspath(zonos_tpu_torch.__file__))) != here:
        fail(f"zonos_tpu_torch was imported from {zonos_tpu_torch.__file__}, not from the "
             f"checkout that holds this script ({here})")
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
                got = fn(q, k, v, length)
                torch.cuda.synchronize()
                err = float((got.float() - ref).abs().max())
                if not err <= tol:
                    fail(f"{name} B={B} length={length}: max abs err {err} > {tol}")
                worst[name] = max(worst[name], err)
    print(f"[kernels] K1/K2 ok at B in (2, 8), lengths (1, 255, 256, 257, 2000), S={S}: "
          f"max abs err {worst} (tolerance 2 bf16 ulps)", flush=True)
    return worst


def check_fused_sample(gen) -> float:
    """K3 vs the plain version on the same logits and Gumbel noise: ids must
    match except where the plain version's top two scores lie within 1e-4.
    Returns the largest |id difference| over all rows."""
    import torch

    from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_scores_plain
    from zonos_tpu_torch.ops.sampling import gumbel_noise

    B, K, V, valid = 8, 9, 1152, 1025
    worst = 0
    logits = torch.randn((B, K, V), generator=gen, device="cuda") * 3.0
    logits[..., valid:] = float("-inf")
    noise = gumbel_noise((B, K, V), gen, "cuda")
    for min_p in (0.0, 0.1):
        kw = dict(linear=0.55, conf=0.4, quad=0.0, min_p=min_p, temperature=1.0)
        scores = fused_sample_scores_plain(logits, noise, **kw)
        ref = scores.argmax(-1)
        top2 = scores.topk(2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) < 1e-4
        got = fused_sample(logits, noise, **kw)
        torch.cuda.synchronize()
        bad = (got != ref) & ~near_tie
        if bool(bad.any()):
            fail(f"fused_sample min_p={min_p}: {int(bad.sum())} ids differ outside near ties")
        worst = max(worst, int((got - ref).abs().max()))
        print(f"[kernels] K3 ok (min_p={min_p}): {int((got == ref).sum())}/{B * K} ids equal, "
              f"{int(near_tie.sum())} near-tie rows", flush=True)
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
    residual-unit shape; tolerance 1e-4 x max|ref|."""
    import torch

    from zonos_tpu_torch.kernels.snake_conv import snake_conv1d, snake_conv1d_plain

    worst = 0.0
    for C, T, dil in residual_unit_shapes(frames):
        p = _unit_params(gen, C)
        x = torch.randn((1, T, C), generator=gen, device="cuda")
        for alpha, conv, d, res in ((p["alpha1"], p["conv1"], dil, None),
                                    (p["alpha2"], p["conv2"], 1, x)):
            ref = snake_conv1d_plain(x, alpha, conv["w"], conv["b"], d, res)
            got = snake_conv1d(x, alpha, conv["w"], conv["b"], d, res)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            if not err <= tol:
                fail(f"snake_conv1d C={C} T={T} k={conv['w'].shape[-1]} dil={d}: "
                     f"max abs err {err} > {tol}")
            worst = max(worst, err / float(ref.abs().max()))
    print(f"[kernels] K5 ok at all 12 residual units x 2 convs (F={frames}): "
          f"worst max-abs-err / max|ref| = {worst:.3g} (tolerance 1e-4)", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


def phase_main_path(card: str):
    import numpy as np
    import torch
    from scipy.io import wavfile

    from zonos_tpu_torch import DACAutoencoder, Zonos, ZonosConfig, make_cond_dict
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
    from zonos_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    model = Zonos(ZonosConfig.from_dict(TRANSFORMER_CONFIG_DICT), seed=0)
    dac = DACAutoencoder(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    print(f"[main] flagship transformer ({n_params / 1e9:.3f} B params, bf16) and 44.1 kHz DAC "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)

    def generate(prefix, batch, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = model.generate(prefix, max_new_tokens=MAX_NEW_TOKENS, batch_size=batch, seed=seed)
        torch.cuda.synchronize()
        return codes, time.perf_counter() - t

    def check_codes(codes, batch):
        if len(codes) != batch:
            fail(f"generate returned {len(codes)} samples, expected {batch}")
        for c in codes:
            if c.ndim != 2 or c.shape[0] != 9 or not 1 <= c.shape[1] <= MAX_NEW_TOKENS:
                fail(f"codes of shape {c.shape}, expected [9, 1..{MAX_NEW_TOKENS}]")
            if c.min() < 0 or c.max() >= 1024:
                fail(f"codes outside [0, 1024): {c.min()}..{c.max()}")

    reset_launch_counts()
    prefix1 = model.prepare_conditioning(make_cond_dict(text=TEXTS[0], speaker=None))
    codes1, dt1 = generate(prefix1, 1, 7)
    codes1b, dt1b = generate(prefix1, 1, 7)
    check_codes(codes1, 1)
    if codes1[0].shape != codes1b[0].shape or not np.array_equal(codes1[0], codes1b[0]):
        fail("batch-1 generate with the same seed gave different codes")
    prefix4 = model.prepare_conditioning(make_cond_dict(text=TEXTS, speaker=None))
    codes4, dt4 = generate(prefix4, 4, [11, 12, 13, 14])
    check_codes(codes4, 4)

    torch.cuda.synchronize()
    t = time.perf_counter()
    wav = dac.decode(codes1[0][None])
    torch.cuda.synchronize()
    dt_dac = time.perf_counter() - t
    if wav.shape != (1, 1, codes1[0].shape[1] * 512) or not np.isfinite(wav).all():
        fail(f"DAC decode gave shape {wav.shape} or non-finite samples")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, "b1.wav")] + [os.path.join(tmp, f"b4_{i}.wav") for i in range(4)]
        dac.save_codes(paths[:1], codes1)
        dac.save_codes(paths[1:], codes4)
        for path in paths:
            sr, data = wavfile.read(path)
            data = data.astype(np.float64) / 32767.0
            rms = float(np.sqrt((data**2).mean()))
            if sr != 44100 or not np.isfinite(data).all() or not rms > 0:
                fail(f"{os.path.basename(path)}: sr {sr}, rms {rms}")
    counts = dict(launch_counts)
    print(f"[main] launches on the main path: {counts}", flush=True)
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    for label, codes, dt in (("batch 1", codes1, dt1), ("batch 1 again", codes1b, dt1b),
                             ("batch 4", codes4, dt4)):
        frames = sum(c.shape[1] for c in codes)
        steps = max(c.shape[1] for c in codes) + 8
        print(f"[main] {label}: {frames} frames in {dt:.2f} s = {frames / dt:.1f} tokens/s "
              f"(frames of 9 codebooks), {dt * 1e3 / steps:.2f} ms per decode step, "
              f"real-time factor {frames / FRAMES_PER_S / dt:.2f} (generate only; {card})",
              flush=True)
    audio_s = codes1[0].shape[1] / FRAMES_PER_S
    print(f"[main] DAC decode of {audio_s:.2f} s of audio in {dt_dac:.3f} s; wavs at 44100 Hz, "
          f"finite, nonzero RMS ({card})", flush=True)
    return counts, model, prefix1


# kernel-name fragments -> category, for the profile summary
_CATEGORIES = (
    ("port kernels", ("flash_split", "flash_combine", "single_pass", "fused_sample",
                      "snake_conv1d")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitK")),
)


def phase_profile(model, prefix, card: str, new_tokens: int = 64) -> None:
    """Where a batch-1 decode step's time goes: one short generate under
    torch.profiler for the device's kernel time, one without it for the
    wall time.  Prints the device busy share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate(prefix, max_new_tokens=new_tokens, seed=3)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()
    wall = run()
    steps = new_tokens + 8  # decode steps after the prefill (the delay adds 8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print("[profile] device busy time not measured (the profiler saw no kernels)", flush=True)
        return
    by_cat: dict[str, float] = {}
    for e in kernels:
        cat = next((c for c, keys in _CATEGORIES if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    print(f"[profile] batch-1 generate, {new_tokens} new tokens ({steps} decode steps + prefill): "
          f"wall {wall * 1e3 / steps:.2f} ms/step, device busy {busy_ms / steps:.2f} ms/step "
          f"= {100 * busy_ms / (wall * 1e3):.1f}% busy, {100 - 100 * busy_ms / (wall * 1e3):.1f}% idle "
          f"({card})", flush=True)
    print("[profile] device ms/step by category: " + ", ".join(
        f"{c} {v / steps:.3f}" for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1])), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:.4f} ms/step  "
              f"x{e.count / steps:.1f}/step  {e.key[:90]}", flush=True)


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
# phase 5: timings
# ---------------------------------------------------------------------------


def _times(kernel, plain) -> dict:
    ms, host_ms = device_ms(kernel)
    return {"ms": ms, "kernel_ms": ms, "host_ms": host_ms, "plain_ms": device_ms(plain)[0]}


def phase_timings(gen, counts: dict, errs: dict) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from zonos_tpu_torch.kernels.decode_attention import (
        decode_attention_plain,
        decode_attention_single,
        flash_decode_attention,
    )
    from zonos_tpu_torch.kernels.sampling import fused_sample, fused_sample_plain
    from zonos_tpu_torch.kernels.snake_conv import (
        snake_conv1d_plain,
        snake_residual_unit,
    )
    from zonos_tpu_torch.ops.sampling import gumbel_noise

    out = []
    H, Hkv, D, S = 16, 4, 128, 2048
    B = 2  # batch 1 with classifier-free guidance
    # On the decode path a layer's cache is read after the other 25 layers'
    # weights have passed through L2, so it comes from HBM.  The timed calls
    # cycle over 8 caches (8 x 8.4 MB > the 50 MB L2) to read it cold too.
    sets = [tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((B, 1, H, D), (B, Hkv, S, D), (B, Hkv, S, D)))
            for _ in range(8)]
    q, k, v = sets[0]
    for name, fn, length, key in (
            ("flash_decode_attention", flash_decode_attention, 2000, "K1"),
            ("decode_attention_single", decode_attention_single, 256, "K2")):
        mask = (torch.arange(S, device="cuda") < length)[None, None, None, :]
        lib_ref = F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask,
                                                 enable_gqa=True).transpose(1, 2).float()
        if not float((lib_ref - fn(q, k, v, length).float()).abs().max()) <= 4 * bf16_ulp(
                float(lib_ref.abs().max())):
            fail(f"library call disagrees with {name}")
        cycle = itertools.cycle(sets)

        def library_call():
            qq, kk, vv = next(cycle)
            return F.scaled_dot_product_attention(qq.transpose(1, 2), kk, vv, attn_mask=mask,
                                                  enable_gqa=True)

        nbytes = 2 * (2 * B * Hkv * length * D + 2 * B * H * D)
        flops = 4 * B * H * length * D
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
        out.append({
            "name": name, "id": key, "route": "cuda",
            "source": "zonos_tpu_torch/csrc/decode_attention.cu",
            "replaces": ("zonos_tpu/ops/pallas_kernels.py:147" if key == "K1"
                         else "zonos_tpu/ops/pallas_kernels.py:58"),
            "launches": counts[name],
            "max_abs_err": errs[name],
            "shape": f"q [{B},1,{H},{D}] bf16, k/v [{B},{Hkv},{S},{D}] bf16, length {length}",
            **_times(lambda: fn(*next(cycle), length),
                     lambda: decode_attention_plain(*next(cycle), length)),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S else "operations",
            "library_ms": device_ms(library_call)[0],
        })

    Bs, K, V = 1, 9, 1152  # batch 1: sampling runs on the CFG-blended logits
    logits = torch.randn((Bs, K, V), generator=gen, device="cuda") * 3.0
    logits[..., 1025:] = float("-inf")
    noise = gumbel_noise((Bs, K, V), gen, "cuda")
    kw = dict(linear=0.55, conf=0.4, quad=0.0, min_p=0.0, temperature=1.0)
    nbytes = 2 * Bs * K * V * 4 + Bs * K * 8
    out.append({
        "name": "fused_sample", "id": "K3", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/sampling.cu",
        "replaces": "zonos_tpu/ops/pallas_kernels.py:232",
        "launches": counts["fused_sample"],
        "max_abs_err": errs["fused_sample"],
        "shape": f"logits/noise [{Bs},{K},{V}] fp32",
        **_times(lambda: fused_sample(logits, noise, **kw),
                 lambda: fused_sample_plain(logits, noise, **kw)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    })

    frames = 86
    ms = plain_ms = host_ms = bound = 0.0
    bound_ops = bound_bytes = 0.0
    for C, T, dil in residual_unit_shapes(frames):
        p = _unit_params(gen, C)
        x = torch.randn((1, T, C), generator=gen, device="cuda")
        unit_ms, unit_host = device_ms(lambda: snake_residual_unit(p, x, dil), calls=5)
        ms += unit_ms
        host_ms += unit_host

        def plain_unit():
            y = snake_conv1d_plain(x, p["alpha1"], p["conv1"]["w"], p["conv1"]["b"], dil)
            return snake_conv1d_plain(y, p["alpha2"], p["conv2"]["w"], p["conv2"]["b"], 1, x)

        plain_ms += device_ms(plain_unit, calls=5)[0]
        for kk, extra in ((7, 0), (1, T * C)):  # second conv also reads the residual
            f = 2 * T * C * C * kk
            b = 4 * (2 * T * C + kk * C * C + 2 * C + extra)
            bound_ops += f / FP32_FLOPS_PER_S
            bound_bytes += b / HBM_BYTES_PER_S
            bound += max(f / FP32_FLOPS_PER_S, b / HBM_BYTES_PER_S)
    out.append({
        "name": "snake_conv1d", "id": "K5", "route": "cuda",
        "source": "zonos_tpu_torch/csrc/snake_conv.cu",
        "replaces": "zonos_tpu/ops/pallas_dac.py:47",
        "launches": counts["snake_conv1d"],
        "max_abs_err": errs["snake_conv1d"],
        "shape": f"all 12 DAC decoder residual units (24 launches) for {frames} frames, batch 1, fp32",
        "ms": ms,
        "kernel_ms": ms,
        "host_ms": host_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound * 1e3,
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
    })
    return out


def main() -> int:
    card = phase_device()
    import torch

    torch.backends.cudnn.allow_tf32 = False  # fp32 references really in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = dict(check_decode_attention(gen))
    errs["fused_sample"] = check_fused_sample(gen)
    errs["snake_conv1d"] = check_snake_conv(gen)
    counts, model, prefix = phase_main_path(card)
    phase_profile(model, prefix, card)
    del model
    kernels = phase_timings(gen, counts, errs)
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
    sys.exit(main())
