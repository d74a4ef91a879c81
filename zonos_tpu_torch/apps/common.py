"""Shared app plumbing: model loading, conditioning/sampling argparse groups
(the port of zonos_tpu/apps/common.py).

The flags are the reference CLIs' (zonos_cli.py:62-96,
zonos_batch_cli.py:235-275), so scripts port over unchanged, plus
``--device`` (default ``cuda``: the apps run on the card, and raise without
one, unless ``--device cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def add_conditioning_args(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("conditioning")
    g.add_argument("--language", default="en-us", help="Language code (e.g. en-us, de).")
    g.add_argument("--reference_audio", default=None,
                   help="Reference speaker clip for voice cloning (wav).")
    g.add_argument("--prefix_audio", default=None,
                   help="Audio to continue from (default: 100 ms of silence).")
    g.add_argument("--emotion", nargs=8, type=float,
                   default=[1.0, 0.05, 0.05, 0.05, 0.05, 0.05, 0.1, 0.2],
                   help="Happiness, Sadness, Disgust, Fear, Surprise, Anger, Other, Neutral.")
    g.add_argument("--fmax", type=float, default=22050.0, help="Max frequency (0-24000).")
    g.add_argument("--pitch_std", type=float, default=45.0, help="Pitch std dev (0-400).")
    g.add_argument("--speaking_rate", type=float, default=15.0, help="Speaking rate (0-40).")
    g.add_argument("--vqscore_8", nargs=8, type=float, default=[0.78] * 8,
                   help="VQScore per 1/8th of audio (hybrid-only).")
    g.add_argument("--ctc_loss", type=float, default=0.0, help="CTC loss target (hybrid-only).")
    g.add_argument("--dnsmos_ovrl", type=float, default=4.0, help="DNSMOS score (hybrid-only).")
    g.add_argument("--speaker_noised", action="store_true", help="Speaker denoise flag (hybrid-only).")
    g.add_argument("--unconditional_keys", nargs="*",
                   default=["emotion", "vqscore_8", "dnsmos_ovrl"])


def add_sampling_args(ap: argparse.ArgumentParser, linear=0.8, conf=0.2,
                      rep=1.5, rep_window=8) -> None:
    g = ap.add_argument_group("generation")
    g.add_argument("--max_new_tokens", type=int, default=86 * 30)
    g.add_argument("--cfg_scale", type=float, default=2.0)
    g.add_argument("--top_p", type=float, default=0.0)
    g.add_argument("--top_k", type=int, default=0)
    g.add_argument("--min_p", type=float, default=0.0)
    g.add_argument("--linear", type=float, default=linear)
    g.add_argument("--conf", type=float, default=conf)
    g.add_argument("--quad", type=float, default=0.0)
    g.add_argument("--repetition_penalty", type=float, default=rep)
    g.add_argument("--repetition_penalty_window", type=int, default=rep_window)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=423)


def add_model_args(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("model")
    g.add_argument("--model", default="Zyphra/Zonos-v0.1-transformer",
                   help="HF repo id or local dir with config.json + model.safetensors.")
    g.add_argument("--backbone", choices=["transformer", "hybrid"], default=None)
    g.add_argument("--device", default="cuda",
                   help="Device to run on (default cuda; raises without a card).")
    g.add_argument("--verbose", action="store_true")
    g.add_argument("--verbose_sampling", action="store_true",
                   help="Per-step sampling-distribution stats (zonos_tpu_torch.sampling.trace "
                        "logger), logged at the decode loop's polls.")
    g.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler trace of generation to DIR/trace.json.")


def sampling_params_from_args(args) -> dict:
    return dict(
        top_p=args.top_p, top_k=args.top_k, min_p=args.min_p,
        linear=args.linear, conf=args.conf, quad=args.quad,
        repetition_penalty=args.repetition_penalty,
        repetition_penalty_window=args.repetition_penalty_window,
        temperature=args.temperature,
    )


def cond_dict_from_args(args, text, speaker) -> dict:
    from zonos_tpu_torch.conditioning import make_cond_dict

    return make_cond_dict(
        text=text,
        speaker=speaker,
        language=args.language,
        emotion=list(args.emotion),
        fmax=args.fmax,
        pitch_std=args.pitch_std,
        speaking_rate=args.speaking_rate,
        vqscore_8=list(args.vqscore_8),
        ctc_loss=args.ctc_loss,
        dnsmos_ovrl=args.dnsmos_ovrl,
        speaker_noised=args.speaker_noised,
        unconditional_keys=set(args.unconditional_keys),
    )


def load_model(args):
    """Load from a local dir / checkpoint if available; random weights
    otherwise, on ``args.device`` (default ``cuda``, which raises without a
    card)."""
    from zonos_tpu_torch.config import (
        HYBRID_CONFIG_DICT,
        TRANSFORMER_CONFIG_DICT,
        ZonosConfig,
    )
    from zonos_tpu_torch.models.tts import Zonos
    from zonos_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    else:
        logging.basicConfig(level=logging.INFO)
    if getattr(args, "verbose_sampling", False):
        from zonos_tpu_torch.ops.sampling import set_sampling_trace

        # the steps write their statistics on the device; generate logs them
        # at its polls.  The child logger's DEBUG level passes the root's
        # INFO level; its records still reach the root's handler
        set_sampling_trace(True)
        logging.getLogger("zonos_tpu_torch.sampling.trace").setLevel(logging.DEBUG)

    name = args.model
    if os.path.isdir(name):
        cfg_path = os.path.join(name, "config.json")
        ckpt = os.path.join(name, "model.safetensors")
        return Zonos.from_local(cfg_path, ckpt if os.path.exists(ckpt) else None, device=device)
    try:
        return Zonos.from_pretrained(name, device=device)
    except FileNotFoundError:
        logging.warning("checkpoint for %s unavailable; using random weights", name)
        d = (HYBRID_CONFIG_DICT if (args.backbone == "hybrid" or "hybrid" in name)
             else TRANSFORMER_CONFIG_DICT)
        return Zonos(ZonosConfig.from_dict(d), device=device)


def make_speaker(args, model) -> np.ndarray | None:
    if not args.reference_audio:
        return None
    from zonos_tpu_torch.audio.io import load_audio, to_mono

    wav, sr = load_audio(args.reference_audio)
    return model.make_speaker_embedding(to_mono(wav), sr)


def prefix_codes(args, model, batch_size: int = 1):
    """Encode --prefix_audio, or 100 ms of silence by default
    (the reference's recommended practice, zonos_cli.py:115-119)."""
    if args.prefix_audio:
        codes = model.autoencoder.load_prefix_audio(args.prefix_audio)
    else:
        silence = np.zeros((1, 1, 4410), np.float32)  # 100 ms @ 44.1 kHz
        codes = model.autoencoder.encode(model.autoencoder.preprocess(silence, 44100))
    if batch_size > 1:
        codes = np.repeat(codes, batch_size, axis=0)
    return codes
