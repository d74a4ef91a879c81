"""Single-utterance synthesis CLI (the port of zonos_tpu/apps/cli.py; the
reference's zonos_cli.py surface), on the card by default:

    python -m zonos_tpu_torch.apps.cli --text "Hello!" --language en-us \
        --reference_audio voice.wav --output out.wav [--long] [--device cuda]
"""

from __future__ import annotations

import argparse

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate speech with the zonos-tpu PyTorch port.")
    ap.add_argument("--text", required=True, help="Text to synthesize.")
    ap.add_argument("--output", default="output.wav", help="Output wav path.")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--no_prefix_silence", action="store_true",
                    help="Skip the default 100 ms silence audio prefix.")
    # parity with zonos_cli.py:94 (there --progress_bar defaults True and
    # cannot actually be turned off; here the negative form can)
    ap.add_argument("--progress_bar", dest="progress_bar", default=True,
                    action="store_true", help="Show progress bar (default).")
    ap.add_argument("--no_progress_bar", dest="progress_bar", action="store_false")
    ap.add_argument("--long", action="store_true",
                    help="long-form mode: split text into duration-budgeted "
                         "segments with audio-prefix voice continuity "
                         "(lifts the model's 30 s cap; zonos_tpu_torch/longform.py)")
    ap.add_argument("--max_segment_seconds", type=float, default=25.0,
                    help="per-segment duration budget in --long mode")
    ap.add_argument("--carry_frames", type=int, default=43,
                    help="codes carried across segment seams in --long mode")
    add_conditioning_args(ap)
    add_sampling_args(ap)
    add_model_args(ap)
    return ap


def main(argv: list[str] | None = None) -> None:
    from zonos_tpu_torch.utils.profiling import PhaseTimer, device_trace

    args = build_parser().parse_args(argv)
    timer = PhaseTimer()
    print("Loading model...")
    with timer.phase("load"):
        model = load_model(args)
    with timer.phase("speaker"):
        speaker = make_speaker(args, model)
    if args.long:
        if args.batch_size != 1:
            raise SystemExit("--long supports batch_size 1")
        from zonos_tpu_torch.audio.io import save_audio
        from zonos_tpu_torch.longform import synthesize_long

        overrides = dict(
            emotion=list(args.emotion), fmax=args.fmax, pitch_std=args.pitch_std,
            speaking_rate=args.speaking_rate, vqscore_8=list(args.vqscore_8),
            ctc_loss=args.ctc_loss, dnsmos_ovrl=args.dnsmos_ovrl,
            speaker_noised=args.speaker_noised,
            unconditional_keys=set(args.unconditional_keys),
        )
        # same prefix-audio semantics as the normal path: user --prefix_audio
        # or the default 100 ms silence, seeding the FIRST segment
        init_prefix = (None if args.no_prefix_silence and not args.prefix_audio
                       else prefix_codes(args, model, 1))
        print("Generating (long-form)...")
        with timer.phase("generate"), device_trace(args.profile):
            wav, seg_codes = synthesize_long(
                model, args.text, language=args.language, speaker=speaker,
                cond_overrides=overrides,
                sampling_params=sampling_params_from_args(args),
                cfg_scale=args.cfg_scale, seed=args.seed,
                max_segment_seconds=args.max_segment_seconds,
                carry_frames=args.carry_frames,
                max_new_tokens=args.max_new_tokens,
                progress_bar=args.progress_bar,
                on_segment=lambda i, n, _w: print(f"segment {i + 1}/{n} done"),
                initial_prefix_codes=init_prefix,
            )
        sr = model.autoencoder.sampling_rate
        # same -23 LUFS target as save_codes' post-processing
        save_audio(args.output, model.autoencoder.normalize_loudness(wav, sr, target_lufs=-23.0),
                   sr)
        print(f"wrote {args.output} ({wav.shape[-1] / sr:.1f} s, "
              f"{len(seg_codes)} segments)")
        return

    prefix = None if args.no_prefix_silence and not args.prefix_audio else prefix_codes(args, model, args.batch_size)

    # one text replicated across the batch (generate requires prefix batch
    # 2*batch_size; a single string would conditions only one row)
    text = args.text if args.batch_size == 1 else [args.text] * args.batch_size
    cond = cond_dict_from_args(args, text, speaker)
    conditioning = model.prepare_conditioning(cond)
    print("Generating...")
    with timer.phase("generate"), device_trace(args.profile):
        codes = model.generate(
            conditioning,
            audio_prefix_codes=prefix,
            max_new_tokens=args.max_new_tokens,
            cfg_scale=args.cfg_scale,
            batch_size=args.batch_size,
            sampling_params=sampling_params_from_args(args),
            seed=args.seed,
            progress_bar=args.progress_bar,
        )
    outputs = (
        [args.output]
        if args.batch_size == 1
        else [args.output.replace(".wav", f"_{i}.wav") for i in range(args.batch_size)]
    )
    model.autoencoder.save_codes(outputs, codes)
    for p in outputs:
        print(f"wrote {p}")


if __name__ == "__main__":
    main()
