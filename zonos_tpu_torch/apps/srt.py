"""SRT long-form generation: subtitle-timed batched synthesis (the port of
zonos_tpu/apps/srt.py; the reference's srt_generate.py surface), on the card
by default:

    python -m zonos_tpu_torch.apps.srt subs.srt --output_dir srt_out \
        [--candidates 16] [--concat all.wav] [--device cuda]

Per segment: compute the time budget to the next subtitle (with buffer and a
2x stretch cap), solve the speaking rate from phoneme count over that budget
(capped at 40), synthesize a batch of candidates, drop duration outliers,
pick the best by quality score, and write wav + metadata JSON.  Metadata
files enable mtime-based incremental regeneration and manual per-segment
overrides (rate/text) that survive re-runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from pathlib import Path

import numpy as np

from zonos_tpu_torch.apps.common import (
    add_conditioning_args,
    add_model_args,
    add_sampling_args,
    cond_dict_from_args,
    load_model,
    make_speaker,
    sampling_params_from_args,
)

TIME_RE = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


def parse_time(s: str) -> float:
    h, m, sec, ms = TIME_RE.match(s.strip()).groups()
    return int(h) * 3600 + int(m) * 60 + int(sec) + int(ms) / 1000.0


def parse_srt(path: str) -> list[dict]:
    """-> [{index, start, end, text}] (ref: srt_generate.py:45-68)."""
    blocks = re.split(r"\n\s*\n", Path(path).read_text(encoding="utf-8").strip())
    segments = []
    for block in blocks:
        lines = [l.strip() for l in block.splitlines() if l.strip()]
        if len(lines) < 2:
            continue
        idx = int(lines[0]) if lines[0].isdigit() else len(segments) + 1
        times = lines[1] if "-->" in lines[1] else lines[0]
        start_s, end_s = [parse_time(t) for t in times.split("-->")]
        text = " ".join(lines[2:] if "-->" in lines[1] else lines[1:])
        segments.append({"index": idx, "start": start_s, "end": end_s, "text": text})
    return segments


def phoneme_count(text: str, language: str) -> int:
    from zonos_tpu_torch.text import phonemize

    return len(phonemize([text], [language])[0].replace(" ", ""))


def solve_speaking_rate(text: str, language: str, available_s: float,
                        max_rate: float = 40.0) -> float:
    """Phonemes over available seconds, capped (ref: srt_generate.py:394-456)."""
    n_ph = max(phoneme_count(text, language), 1)
    return float(min(n_ph / max(available_s, 0.3), max_rate))


def segment_budget(segments: list[dict], i: int, buffer_s: float = 0.2,
                   stretch_cap: float = 2.0) -> float:
    """Time until the next subtitle starts, minus buffer, capped at
    stretch_cap x the nominal duration (ref: srt_generate.py:357-366)."""
    seg = segments[i]
    nominal = seg["end"] - seg["start"]
    if i + 1 < len(segments):
        available = segments[i + 1]["start"] - seg["start"] - buffer_s
    else:
        available = nominal * stretch_cap
    return float(np.clip(available, 0.3, nominal * stretch_cap))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Long-form SRT-timed synthesis.")
    ap.add_argument("srt", help="Input .srt subtitle file.")
    ap.add_argument("--output_dir", default="srt_out")
    ap.add_argument("--candidates", type=int, default=16,
                    help="Candidates per segment (batch).")
    ap.add_argument("--force", action="store_true", help="Regenerate all segments.")
    ap.add_argument("--concat", default=None,
                    help="Also write one concatenated wav at subtitle offsets.")
    ap.add_argument("--buffer", type=float, default=0.2,
                    help="Seconds reserved before the next segment starts "
                         "(ref: srt_generate.py:244).")
    ap.add_argument("--target_rate", type=float, default=None,
                    help="Floor for the solved speaking rate (phonemes/s); "
                         "segments with slack keep at least this pace instead "
                         "of stretching to fill (ref: srt_generate.py:243).")
    add_conditioning_args(ap)
    add_sampling_args(ap)
    add_model_args(ap)
    return ap


def _generate_segment(args, model, speaker, segments, i, seg, srt_mtime,
                      chosen_paths, sr_out) -> None:
    stem = os.path.join(args.output_dir, f"seg_{seg['index']:04d}")
    meta_path = stem + ".json"
    wav_path = stem + ".wav"

    # incremental regeneration + manual overrides (ref: srt_generate.py:280-355)
    meta = {}
    if os.path.exists(meta_path):
        meta = json.loads(Path(meta_path).read_text())
        fresh = os.path.getmtime(meta_path) >= srt_mtime and os.path.exists(wav_path)
        if fresh and not args.force and not meta.get("regenerate", False):
            print(f"[{seg['index']}] up to date, skipping")
            chosen_paths.append((seg, wav_path))
            return

    text = meta.get("text_override") or seg["text"]
    available = segment_budget(segments, i, buffer_s=args.buffer)
    rate = meta.get("speaking_rate_override") or solve_speaking_rate(
        text, args.language, available
    )
    if args.target_rate is not None:
        rate = max(rate, args.target_rate)
    max_tokens = int(min(available * 86 * 1.2 + 86, 86 * 30))
    print(f"[{seg['index']}] budget {available:.2f}s rate {rate:.1f} tokens {max_tokens}")

    args.speaking_rate = rate
    cond = cond_dict_from_args(args, [text] * args.candidates, speaker)
    # bucket the phoneme length and the step budget as the JAX package does, so
    # a segment's codes match it (the exact duration budget is a per-sample cap)
    conditioning = model.prepare_conditioning(cond, pad_to_multiple=32)
    from zonos_tpu_torch.serving.batching import program_frames_bucket

    t0 = time.perf_counter()
    codes = model.generate(
        conditioning,
        max_new_tokens=program_frames_bucket(max_tokens),
        step_limits=max_tokens,
        cfg_scale=args.cfg_scale,
        batch_size=args.candidates,
        sampling_params=sampling_params_from_args(args),
        seed=args.seed + i,
    )
    wavs = model.autoencoder.codes_to_wavs(codes)
    # drop duration outliers, keep candidates fitting the slot
    durs = np.array([w.shape[1] / sr_out for w in wavs])
    ok = [j for j in range(len(wavs)) if durs[j] <= available * 1.1]
    pool = ok or list(range(len(wavs)))
    scores = model.autoencoder.audio_quality(
        [wavs[j] for j in pool], sr_out, qualities=["AQ"], average_overall=False
    )
    best = pool[int(np.argmax([s["AQ"] for s in scores]))]
    from zonos_tpu_torch.audio.io import save_audio

    save_audio(wav_path, wavs[best], sr_out)
    meta.update(
        text=text, speaking_rate=rate, available_s=available,
        duration_s=float(durs[best]), candidates=args.candidates,
        gen_seconds=time.perf_counter() - t0, regenerate=False,
    )
    Path(meta_path).write_text(json.dumps(meta, indent=2))
    chosen_paths.append((seg, wav_path))
    print(f"[{seg['index']}] wrote {wav_path} ({durs[best]:.2f}s)")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    segments = parse_srt(args.srt)
    srt_mtime = os.path.getmtime(args.srt)

    model = load_model(args)
    speaker = make_speaker(args, model)
    sr_out = model.autoencoder.sampling_rate

    chosen_paths = []
    failures = []
    for i, seg in enumerate(segments):
        try:
            _generate_segment(args, model, speaker, segments, i, seg, srt_mtime,
                              chosen_paths, sr_out)
        except Exception as e:  # keep long jobs alive past one bad segment
            # (ref: srt_generate.py:543-547 wraps per-file work in try/except)
            failures.append((seg["index"], repr(e)))
            print(f"[{seg['index']}] FAILED: {e!r} — continuing")
    if failures:
        print(f"{len(failures)} segment(s) failed: {[i for i, _ in failures]}")
    if args.concat:
        from zonos_tpu_torch.audio.io import load_audio, save_audio

        total = segments[-1]["end"] + 5.0
        out = np.zeros((1, int(total * sr_out)), np.float32)
        for seg, path in chosen_paths:
            w, _ = load_audio(path)
            start = int(seg["start"] * sr_out)
            end = min(start + w.shape[1], out.shape[1])
            out[:, start:end] += w[:, : end - start]
        save_audio(args.concat, np.clip(out, -1, 1), sr_out)
        print(f"wrote {args.concat}")


if __name__ == "__main__":
    main()
