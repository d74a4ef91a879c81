"""Batch synthesis CLI (the port of zonos_tpu/apps/batch_cli.py; the
reference's zonos_batch_cli.py surface), on the card by default:

    python -m zonos_tpu_torch.apps.batch_cli --text "One." "Two." \
        --output_dir batch_out [--score] [--device cuda]

Multi-text batches from flags, a file or the random corpus; per-batch
repeats with the seed incremented; the batch size sized from the card's
memory and the texts chunked to it; prefix-audio continuation with its
transcript prepended; per-sample quality scores and a best-first ranking;
phase timing.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from zonos_tpu_torch.apps.common import (
    add_conditioning_args,
    add_model_args,
    add_sampling_args,
    cond_dict_from_args,
    load_model,
    make_speaker,
    prefix_codes,
    sampling_params_from_args,
)
from zonos_tpu_torch.speaker_db import SpeakerUtils

DEFAULT_MEMORY = 16 * 2**30  # bytes assumed where the device reports none (the CPU)


def estimate_max_batch(max_new_tokens: int, device=None) -> int:
    """A memory-based batch-size heuristic (the reference's VRAM model,
    zonos_batch_cli.py:308-325): the card's memory less ~6 GB of weights and
    workspace, over a sample's bf16 KV cache at the flagship's widths,
    ``2 (k, v) x 2 (CFG) x 26 layers x 4 kv heads x 128 x seq x 2 bytes``."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = DEFAULT_MEMORY
    base = 6 * 2**30
    seq = max_new_tokens + 256
    per_sample = 2 * 2 * 26 * 4 * 128 * seq * 2
    return max(1, int((total - base) // per_sample))


def chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Batch speech generation with the zonos-tpu "
                                             "PyTorch port.")
    ap.add_argument("--text", nargs="*", default=None, help="One or more texts.")
    ap.add_argument("--text_file", default=None, help="File with one text per line.")
    ap.add_argument("--text_random", type=int, default=0,
                    help="Generate N random corpus sentences.")
    ap.add_argument("--text_repeat", type=int, default=1, help="Repeat each text K times.")
    ap.add_argument("--batch_repeat", type=int, default=1,
                    help="Re-run the whole batch K times, seed incremented per run.")
    ap.add_argument("--max_per_batch", type=int, default=0,
                    help="Chunk size; 0 = auto from device memory.")
    ap.add_argument("--output_dir", default="batch_out")
    ap.add_argument("--score", action="store_true", help="Score outputs and report best-of-N.")
    ap.add_argument("--transcripts", default=None,
                    help="transcripts.json mapping prefix-audio stems to text to prepend.")
    add_conditioning_args(ap)
    add_sampling_args(ap)
    add_model_args(ap)
    return ap


def collect_texts(args) -> list[str]:
    texts: list[str] = []
    if args.text:
        texts += list(args.text)
    if args.text_file:
        texts += [t.strip() for t in Path(args.text_file).read_text().splitlines() if t.strip()]
    if args.text_random:
        texts += [SpeakerUtils.random_sentence(args.language) for _ in range(args.text_random)]
    if not texts:
        texts = [SpeakerUtils.random_sentence(args.language)]
    return [t for t in texts for _ in range(args.text_repeat)]


def main(argv: list[str] | None = None) -> list[str]:
    """Runs the CLI; returns the WAV paths written."""
    from zonos_tpu_torch.audio.io import load_audio
    from zonos_tpu_torch.utils.profiling import PhaseTimer, device_trace

    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    timer = PhaseTimer()
    with timer.phase("model load"):
        model = load_model(args)
    with timer.phase("speaker embed"):
        speaker = make_speaker(args, model)

    texts = collect_texts(args)
    # prepend the prefix audio's transcript, so the continuation's text flows on
    # (the reference: zonos_batch_cli.py:100-102, 356-368)
    if args.transcripts and args.prefix_audio:
        tr = json.loads(Path(args.transcripts).read_text())
        stem = Path(args.prefix_audio).stem
        if stem in tr:
            texts = [tr[stem] + " " + t for t in texts]

    max_per_batch = args.max_per_batch or estimate_max_batch(args.max_new_tokens, model.device)
    print(f"texts: {len(texts)}, max_per_batch: {max_per_batch}")

    all_wav_paths: list[str] = []
    t2 = time.perf_counter()
    idx = 0
    with device_trace(getattr(args, "profile", None)):
        for rep in range(args.batch_repeat):
            seed = args.seed + rep
            for chunk in chunks(texts, max_per_batch):
                bsz = len(chunk)
                prefix = prefix_codes(args, model, bsz) if args.prefix_audio else None
                cond = cond_dict_from_args(args, list(chunk), speaker)
                conditioning = model.prepare_conditioning(cond)
                codes = model.generate(
                    conditioning,
                    audio_prefix_codes=prefix,
                    max_new_tokens=args.max_new_tokens,
                    cfg_scale=args.cfg_scale,
                    batch_size=bsz,
                    sampling_params=sampling_params_from_args(args),
                    seed=seed,
                )
                paths = [os.path.join(args.output_dir, f"gen_{idx + i:04d}_s{seed}.wav")
                         for i in range(bsz)]
                model.autoencoder.save_codes(paths, codes)
                all_wav_paths += paths
                idx += bsz
    gen_s = time.perf_counter() - t2
    total_audio = 0.0
    for p in all_wav_paths:
        w, sr = load_audio(p)
        total_audio += w.shape[1] / sr
    print(f"[t] generate+decode: {gen_s:.1f}s for {total_audio:.1f}s audio "
          f"({total_audio / max(gen_s, 1e-9):.2f}x realtime)")

    if args.score:
        wavs = [load_audio(p)[0] for p in all_wav_paths]
        per = model.autoencoder.audio_quality(wavs, 44100, qualities=["AQ"],
                                              average_overall=False)
        ranked = sorted(zip(all_wav_paths, per), key=lambda kv: -kv[1]["AQ"])
        print("quality ranking (best first):")
        for p, q in ranked:
            print(f"  {q['AQ']:.2f}  {p}")
    return all_wav_paths


if __name__ == "__main__":
    main()
