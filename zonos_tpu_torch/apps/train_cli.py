"""The training CLI: dataset -> train loop -> checkpoints -> export
(zonos_tpu/apps/train_cli.py).

    data/ (manifest | LJSpeech | wav+txt dir; the DAC-code disk cache, encoded
           on the card; length-pooled bucketed batches; a prefetch thread)
 -> parallel/train.py (the conditioned multi-codebook loss with CFG dropout,
           AdamW or Adafactor, warmup-cosine, clipping, remat, accumulation)
    or parallel/lora.py (rank-r adapters over a frozen base)
 -> utils/train_state.py (checkpoints, resume from the newest)
 -> utils/checkpoint.py (``--export``: reference-format weights, LoRA merged)

One device (``--device``, the card by default).  The JAX package's mesh
(``--dp`` / ``--tp`` past 1) is refused: the distributed slice of the port
is not written yet.

Examples
--------
    python -m zonos_tpu_torch.apps.train_cli --ljspeech /data/LJSpeech-1.1 \\
        --steps 10000 --batch 16 --ckpt_dir ckpts
    python -m zonos_tpu_torch.apps.train_cli --manifest data.jsonl --model hybrid \\
        --pretrained Zyphra/Zonos-v0.1-hybrid --lr 1e-5 --steps 2000
    python -m zonos_tpu_torch.apps.train_cli --dir clips/ --tiny --device cpu --steps 2
"""

from __future__ import annotations

import argparse
import copy
import logging
import time

import numpy as np
import torch

log = logging.getLogger("zonos_tpu_torch.train")


def _build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train / finetune a zonos model with the port")
    src = ap.add_argument_group("data")
    src.add_argument("--manifest", help="JSONL manifest with {audio, text, ...} rows")
    src.add_argument("--ljspeech", help="LJSpeech-layout dataset root (metadata.csv + wavs/)")
    src.add_argument("--dir", help="directory of <name>.wav + <name>.txt pairs")
    src.add_argument("--language", default="en-us", help="language for --ljspeech/--dir sources")
    src.add_argument("--cache_dir", default=".codes_cache", help="DAC-code cache directory")
    src.add_argument("--speaker_embed", action="store_true",
                     help="condition on per-example speaker embeddings from the "
                          "speaker tower (cached); default trains speaker-unconditional")
    src.add_argument("--max_seconds", type=float, default=30.0,
                     help="drop clips longer than this (model cap is 30 s)")

    mdl = ap.add_argument_group("model")
    mdl.add_argument("--model", choices=["transformer", "hybrid"], default="transformer")
    mdl.add_argument("--pretrained", default=None,
                     help="repo id under the models directory to finetune from "
                          "(reference-format checkpoint; nothing is downloaded)")
    mdl.add_argument("--tiny", action="store_true",
                     help="tiny debug config (fast CPU smoke runs)")
    mdl.add_argument("--param_dtype", choices=["float32", "bfloat16"], default="float32",
                     help="training parameter dtype (bfloat16 runs the products on G1)")

    tr = ap.add_argument_group("optimization")
    tr.add_argument("--steps", type=int, default=1000)
    tr.add_argument("--batch", type=int, default=8)
    tr.add_argument("--lr", type=float, default=3e-4)
    tr.add_argument("--warmup", type=int, default=100)
    tr.add_argument("--weight_decay", type=float, default=0.01)
    tr.add_argument("--grad_clip", type=float, default=1.0)
    tr.add_argument("--lora_rank", type=int, default=0,
                    help="train rank-r LoRA adapters on the backbone projections "
                         "instead of full weights; --export merges them")
    tr.add_argument("--lora_alpha", type=float, default=16.0,
                    help="LoRA scale: merged W = base + (alpha/r)*A@B")
    tr.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw",
                    help="adafactor's factored second moment stores O(rows+cols) "
                         "a matrix instead of AdamW's two moments of every parameter")
    tr.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation micro-batches per step "
                         "(peak activation memory scales with batch/accum)")
    tr.add_argument("--uncond_p", type=float, default=0.1,
                    help="classifier-free-guidance dropout probability per conditioner")
    tr.add_argument("--remat", action="store_true",
                    help="recompute backbone layers in the backward pass")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--phoneme_bucket", type=int, default=16)
    tr.add_argument("--code_bucket", type=int, default=64)
    tr.add_argument("--val_frac", type=float, default=0.0,
                    help="hold out this fraction of examples (deterministic "
                         "in --seed) and report their loss every --eval_every steps")
    tr.add_argument("--eval_every", type=int, default=100)

    rt = ap.add_argument_group("runtime")
    rt.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    rt.add_argument("--ckpt_dir", default=None, help="train-state checkpoint directory")
    rt.add_argument("--export", default=None, metavar="DIR",
                    help="after training, write config.json + model.safetensors "
                         "in the reference's format (loads through Zonos.from_local)")
    rt.add_argument("--ckpt_every", type=int, default=500)
    rt.add_argument("--resume", action="store_true", help="resume from the newest checkpoint")
    rt.add_argument("--log_every", type=int, default=10)
    rt.add_argument("--dp", type=int, default=0,
                    help="data-parallel size: 0 or 1 (one device; a mesh is not ported yet)")
    rt.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: 1 (a mesh is not ported yet)")
    rt.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace of the train loop to this dir")
    rt.add_argument("--verbose", action="store_true")
    return ap


def _collect_examples(args):
    from zonos_tpu_torch.data import read_manifest, scan_dir, scan_ljspeech

    if args.manifest:
        return read_manifest(args.manifest)
    if args.ljspeech:
        return scan_ljspeech(args.ljspeech, args.language)
    if args.dir:
        return scan_dir(args.dir, args.language)
    raise SystemExit("one of --manifest / --ljspeech / --dir is required")


def _build_model(args):
    from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT, ZonosConfig
    from zonos_tpu_torch.models.tts import Zonos

    if args.pretrained:
        return Zonos.from_pretrained(args.pretrained, device=args.device)
    base = TRANSFORMER_CONFIG_DICT if args.model == "transformer" else HYBRID_CONFIG_DICT
    d = copy.deepcopy(base)
    if args.tiny:
        if args.model == "transformer":
            d["backbone"].update(
                d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                attn_cfg={"num_heads": 4, "num_heads_kv": 2},
            )
        else:
            d["backbone"].update(
                d_model=64, n_layer=4, attn_layer_idx=[1, 3], attn_mlp_d_intermediate=128,
                ssm_cfg={"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16},
                attn_cfg={"num_heads": 4, "num_heads_kv": 2, "head_dim": 16,
                          "rotary_emb_dim": 8},
            )
    return Zonos(ZonosConfig.from_dict(d), seed=args.seed, device=args.device)


def _cast(params, dtype: torch.dtype):
    """Every floating leaf in ``dtype`` (the JAX CLI casts every one)."""
    from zonos_tpu_torch.parallel.train import tree_flatten

    leaves, rebuild = tree_flatten(params)
    return rebuild([t.to(dtype) if t is not None and t.is_floating_point() else t
                    for t in leaves])


def _device_put_fn(device: torch.device):
    """Moves a loader batch's arrays to ``device`` (in the prefetch thread)."""

    def put(batch: dict) -> dict:
        return {"cond_inputs": {k: None if v is None else torch.as_tensor(v).to(device)
                                for k, v in batch["cond_inputs"].items()},
                "codes": torch.as_tensor(batch["codes"]).to(device)}

    return put


def main(argv: list[str] | None = None) -> None:
    args = _build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.dp > 1 or args.tp > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: training over a mesh comes with the port's "
            "distributed slice (parallel/mesh.py, sharding.py); this CLI runs one device "
            "(--dp 0 or 1, --tp 1)")

    from zonos_tpu_torch.data import BatchSpec, CodesCache, PrefetchLoader, prepare_examples
    from zonos_tpu_torch.data.dataset import FRAME_RATE, total_audio_seconds
    from zonos_tpu_torch.parallel.train import make_conditioned_train_step, make_optimizer
    from zonos_tpu_torch.utils.train_state import profile_trace

    examples = _collect_examples(args)
    log.info("dataset: %d examples", len(examples))

    model = _build_model(args)
    cfg = model.config
    device = model.device

    speaker_fn = None
    if args.speaker_embed:
        from zonos_tpu_torch.speaker_db import SpeakerUtils

        speaker_fn = SpeakerUtils(model=model).get_speaker_embedding

    cache = CodesCache(model.autoencoder, args.cache_dir)
    t0 = time.time()
    prepared = prepare_examples(examples, cache, speaker_fn=speaker_fn, on_error="skip")
    if not prepared:
        raise SystemExit("no usable examples after preparation")
    log.info("prepared %d examples (%.1f s of audio; %d fresh encodes) in %.1fs",
             len(prepared), total_audio_seconds(prepared), cache.encode_calls,
             time.time() - t0)

    val = []
    if args.val_frac > 0:
        rng = np.random.default_rng(args.seed)
        order = rng.permutation(len(prepared))
        n_val = max(1, int(len(prepared) * args.val_frac))
        if n_val >= len(prepared):
            raise SystemExit(f"--val_frac {args.val_frac} leaves no training data")
        val = [prepared[i] for i in order[:n_val]]
        prepared = [prepared[i] for i in order[n_val:]]
        log.info("holding out %d examples for validation", n_val)

    dtype = torch.float32 if args.param_dtype == "float32" else torch.bfloat16
    params = _cast(model.params, dtype)

    lora = args.lora_rank > 0
    if lora and args.accum > 1:
        raise SystemExit("--lora_rank does not combine with --accum "
                         "(adapters are tiny; accumulation buys nothing)")
    optimizer = make_optimizer(lr=args.lr, weight_decay=args.weight_decay,
                               warmup_steps=args.warmup, total_steps=args.steps,
                               grad_clip=args.grad_clip, kind=args.optimizer)

    # --- trainable: full params or LoRA adapters over a frozen base -------
    if lora:
        from zonos_tpu_torch.parallel.lora import (
            count_lora_params,
            init_lora,
            make_lora_eval_fn,
            make_lora_train_step,
        )

        trainable = init_lora(torch.Generator().manual_seed(args.seed ^ 0x10A4), params,
                              rank=args.lora_rank)
        log.info("LoRA rank %d: %d adapter params", args.lora_rank,
                 count_lora_params(trainable))
        lora_step = make_lora_train_step(cfg, model.specs, optimizer, alpha=args.lora_alpha,
                                         uncond_p=args.uncond_p, remat=args.remat)

        def step_fn(t, o, ci, c, g):
            return lora_step(t, o, params, ci, c, g)
    else:
        trainable = params
        step_fn = make_conditioned_train_step(cfg, model.specs, optimizer,
                                              uncond_p=args.uncond_p, remat=args.remat,
                                              accum_steps=args.accum)
    opt_state = optimizer.init(trainable)

    # --- resume ----------------------------------------------------------
    start_step = 0
    if args.ckpt_dir and args.resume:
        from zonos_tpu_torch.utils.train_state import restore_train_state

        restored = restore_train_state(args.ckpt_dir, trainable, opt_state)
        if restored is not None:
            start_step, trainable, opt_state = restored
            log.info("resumed from step %d", start_step)

    bs = BatchSpec(batch_size=args.batch, phoneme_bucket=args.phoneme_bucket,
                   code_bucket=args.code_bucket,
                   max_code_len=int(args.max_seconds * FRAME_RATE),
                   eos_token_id=cfg.eos_token_id)
    put = _device_put_fn(device)
    loader = PrefetchLoader(prepared, model.specs, cfg.masked_token_id, bs,
                            seed=args.seed, device_put_fn=put, start_step=start_step)

    eval_fn, val_batches = None, []
    if val:
        from zonos_tpu_torch.data import iter_epoch_batches
        from zonos_tpu_torch.parallel.train import make_conditioned_eval_fn

        val_batches = [put(b) for b in iter_epoch_batches(
            val, model.specs, cfg.masked_token_id, bs, seed=args.seed, epoch=0)]
        if lora:
            lora_eval = make_lora_eval_fn(cfg, model.specs, alpha=args.lora_alpha,
                                          remat=args.remat)

            def eval_fn(t, ci, c):
                return lora_eval(t, params, ci, c)
        else:
            eval_fn = make_conditioned_eval_fn(cfg, model.specs, remat=args.remat)

    def run_eval(trainable, step):
        vl = float(np.mean([float(eval_fn(trainable, b["cond_inputs"], b["codes"]))
                            for b in val_batches]))
        log.info("step %d  val_loss %.4f (%d batches)", step, vl, len(val_batches))
        return vl

    frames_seen = 0
    t_log = time.time()
    last_loss = float("nan")
    last_ckpt = start_step
    with profile_trace(args.profile):
        try:
            for step, batch in loader:
                if step >= args.steps:
                    break
                # the CFG dropout masks of this step: a function of (seed, step)
                gen = torch.Generator().manual_seed((args.seed ^ 0x7A0705) * 1_000_003 + step)
                trainable, opt_state, loss = step_fn(
                    trainable, opt_state, batch["cond_inputs"], batch["codes"], gen)
                frames_seen += batch["codes"].shape[0] * batch["codes"].shape[-1]
                if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                    last_loss = float(loss)  # a host read, once every log_every steps
                    dt = time.time() - t_log
                    log.info("step %d  loss %.4f  %.0f frames/s (%.1fx realtime audio)",
                             step + 1, last_loss, frames_seen / dt,
                             frames_seen / dt / FRAME_RATE)
                    frames_seen, t_log = 0, time.time()
                if eval_fn is not None and ((step + 1) % args.eval_every == 0
                                            or step + 1 == args.steps):
                    run_eval(trainable, step + 1)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    from zonos_tpu_torch.utils.train_state import save_train_state

                    save_train_state(args.ckpt_dir, step + 1, trainable, opt_state)
                    last_ckpt = step + 1
                    log.info("checkpoint @ step %d", step + 1)
        finally:
            loader.stop()

    # start_step >= steps: a resumed run that did no work; writing the
    # restored (later-step) state labelled as args.steps would regress it
    if args.ckpt_dir and last_ckpt != args.steps and start_step < args.steps:
        from zonos_tpu_torch.utils.train_state import save_train_state

        save_train_state(args.ckpt_dir, args.steps, trainable, opt_state)
    if args.export:
        from zonos_tpu_torch.utils.checkpoint import export_zonos_checkpoint

        out_params = trainable
        if lora:
            from zonos_tpu_torch.parallel.lora import merge_lora

            out_params = merge_lora(params, trainable, alpha=args.lora_alpha)
        path = export_zonos_checkpoint(cfg, out_params, args.export)
        log.info("exported reference-format checkpoint: %s", path)
    log.info("done: %d steps, final loss %.4f", args.steps, last_loss)


if __name__ == "__main__":
    main()
