"""The training CLI: dataset -> train loop -> checkpoints -> export
(zonos_tpu/apps/train_cli.py).

    data/ (manifest | LJSpeech | wav+txt dir; the DAC-code disk cache, encoded
           on the card; length-pooled bucketed batches; a prefetch thread)
 -> parallel/train.py (the conditioned multi-codebook loss with CFG dropout,
           AdamW or Adafactor, warmup-cosine, clipping, remat, accumulation)
    or parallel/lora.py (rank-r adapters over a frozen base)
 -> utils/train_state.py (checkpoints, resume from the newest)
 -> utils/checkpoint.py (``--export``: reference-format weights, LoRA merged)

One device (``--device``, the card by default), or a ``("data", "model")``
mesh of one process a device (``--dp`` / ``--tp``, as the JAX CLI's),
launched by torchrun: every rank loads the same batches, the data axis splits
their rows, the model axis shards the backbone and the heads
(``parallel/``).  ``--dp 0`` picks the largest data size that divides
``--batch``; the world must hold ``dp * tp`` processes.  LoRA adapters are
replicated.  Rank 0 alone logs and writes checkpoints (the whole parameters
and optimizer state, gathered over the model axis) and the export.

Examples
--------
    python -m zonos_tpu_torch.apps.train_cli --ljspeech /data/LJSpeech-1.1 \\
        --steps 10000 --batch 16 --ckpt_dir ckpts
    python -m zonos_tpu_torch.apps.train_cli --manifest data.jsonl --model hybrid \\
        --pretrained Zyphra/Zonos-v0.1-hybrid --lr 1e-5 --steps 2000
    python -m zonos_tpu_torch.apps.train_cli --dir clips/ --tiny --device cpu --steps 2
    torchrun --standalone --nproc_per_node 4 -m zonos_tpu_torch.apps.train_cli \
        --dir clips/ --tiny --device cpu --dp 2 --tp 2 --batch 4 --steps 2
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
                    help="data-parallel size (0: the largest that divides --batch); "
                         "past one process, launch with torchrun")
    rt.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (the backbone's heads and MLP, the vocab)")
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


def _mesh(args):
    """The ``(data, model)`` mesh of a torchrun launch (None for one
    process), with ``args.device`` set to this rank's device."""
    import os

    import torch.distributed as dist

    from zonos_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if args.dp > 1 or args.tp > 1:
            raise SystemExit(f"--dp {args.dp} --tp {args.tp} needs one process a device: launch "
                             "with torchrun --standalone --nproc_per_node <dp*tp> -m "
                             "zonos_tpu_torch.apps.train_cli ...")
        return None
    cuda = torch.device(args.device).type == "cuda"
    initialize_multihost(backend="nccl" if cuda else "gloo")
    world = dist.get_world_size()
    if args.dp and args.batch % args.dp:
        raise SystemExit(f"--batch {args.batch} not divisible by --dp {args.dp}")
    dp = args.dp or world // args.tp
    while args.batch % dp:  # auto: the largest dp that divides the batch
        dp -= 1
    if dp * args.tp != world:
        raise SystemExit(f"a {dp}x{args.tp} mesh needs {dp * args.tp} processes; this world "
                         f"has {world} (torchrun --nproc_per_node {dp * args.tp})")
    if cuda:
        args.device = f"cuda:{os.environ.get('LOCAL_RANK', dist.get_rank())}"
    return make_mesh(dp, args.tp, args.device)


def main(argv: list[str] | None = None) -> None:
    args = _build_argparser().parse_args(argv)
    mesh = _mesh(args)
    lead = mesh is None or mesh.get_rank() == 0
    logging.basicConfig(level=(logging.DEBUG if args.verbose else logging.INFO) if lead
                        else logging.WARNING, format="%(asctime)s %(name)s %(message)s")
    try:
        _train(args, mesh, lead)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()
            dist.destroy_process_group()


def _train(args, mesh, lead: bool) -> None:
    from zonos_tpu_torch.data import BatchSpec, CodesCache, PrefetchLoader, prepare_examples
    from zonos_tpu_torch.data.dataset import FRAME_RATE, total_audio_seconds
    from zonos_tpu_torch.ops.tp import mesh_shape
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
    if mesh is not None and not lead:  # rank 0 fills the codes cache, the others read it
        import torch.distributed as dist

        dist.barrier()
    prepared = prepare_examples(examples, cache, speaker_fn=speaker_fn, on_error="skip")
    if mesh is not None and lead:
        import torch.distributed as dist

        dist.barrier()
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

    # --- mesh: the base sharded over "model"; adapters made whole ---------
    tp = 1 if mesh is None else mesh_shape(mesh)["model"]
    if lora:
        from zonos_tpu_torch.parallel.lora import (
            count_lora_params,
            init_lora,
            make_lora_eval_fn,
            make_lora_train_step,
        )

        adapters = init_lora(torch.Generator().manual_seed(args.seed ^ 0x10A4), params,
                             rank=args.lora_rank)
    if mesh is not None:
        from zonos_tpu_torch.parallel.sharding import shard_params, zonos_param_specs

        log.info("mesh: %s over %d processes", mesh_shape(mesh), mesh.size())
        params = shard_params(mesh, params, cfg)
        model.params = None  # the whole parameters are not kept
    # the spec tree of what trains: the base's, or none (replicated adapters)
    specs = None
    if mesh is not None and not lora:
        specs = zonos_param_specs(params, cfg)
    optimizer = make_optimizer(lr=args.lr, weight_decay=args.weight_decay,
                               warmup_steps=args.warmup, total_steps=args.steps,
                               grad_clip=args.grad_clip, kind=args.optimizer, mesh=mesh,
                               specs=specs)

    # --- trainable: full params or LoRA adapters over a frozen base -------
    if lora:
        trainable = adapters
        log.info("LoRA rank %d: %d adapter params", args.lora_rank,
                 count_lora_params(trainable))
        lora_step = make_lora_train_step(cfg, model.specs, optimizer, alpha=args.lora_alpha,
                                         uncond_p=args.uncond_p, remat=args.remat, mesh=mesh)

        def step_fn(t, o, ci, c, g):
            return lora_step(t, o, params, ci, c, g)
    else:
        trainable = params
        step_fn = make_conditioned_train_step(cfg, model.specs, optimizer,
                                              uncond_p=args.uncond_p, remat=args.remat,
                                              accum_steps=args.accum, mesh=mesh)
    opt_state = optimizer.init(trainable)
    state_io = _StateIO(mesh, cfg, specs, tp)

    # --- resume ----------------------------------------------------------
    start_step = 0
    if args.ckpt_dir and args.resume:
        restored = state_io.restore(args.ckpt_dir, trainable, opt_state)
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
                                          remat=args.remat, mesh=mesh)

            def eval_fn(t, ci, c):
                return lora_eval(t, params, ci, c)
        else:
            eval_fn = make_conditioned_eval_fn(cfg, model.specs, remat=args.remat, mesh=mesh)

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
                    state_io.save(args.ckpt_dir, step + 1, trainable, opt_state)
                    last_ckpt = step + 1
                    log.info("checkpoint @ step %d", step + 1)
        finally:
            loader.stop()

    # start_step >= steps: a resumed run that did no work; writing the
    # restored (later-step) state labelled as args.steps would regress it
    if args.ckpt_dir and last_ckpt != args.steps and start_step < args.steps:
        state_io.save(args.ckpt_dir, args.steps, trainable, opt_state)
    if args.export:
        from zonos_tpu_torch.utils.checkpoint import export_zonos_checkpoint

        out_params = state_io.whole(params if lora else trainable)
        if lora:
            from zonos_tpu_torch.parallel.lora import merge_lora

            out_params = merge_lora(out_params, trainable, alpha=args.lora_alpha)
        if lead:
            path = export_zonos_checkpoint(cfg, out_params, args.export)
            log.info("exported reference-format checkpoint: %s", path)
    log.info("done: %d steps, final loss %.4f", args.steps, last_loss)


class _StateIO:
    """Train-state checkpoints on a mesh: rank 0 writes the whole parameters
    and optimizer state (gathered over the model axis, so a checkpoint
    resumes on any mesh); every rank reads it and keeps its shard."""

    def __init__(self, mesh, cfg, specs, tp: int):
        self.mesh, self.cfg, self.specs, self.tp = mesh, cfg, specs, tp

    def _state_specs(self, trainable, opt_state):
        from zonos_tpu_torch.parallel.train import optimizer_state_specs

        return optimizer_state_specs(opt_state, trainable, self.specs, self.mesh)

    def whole(self, params):
        """The whole base parameters (a collective over the model axis)."""
        if self.tp == 1:
            return params
        from zonos_tpu_torch.parallel.sharding import unshard_params

        return unshard_params(self.mesh, params, self.cfg)

    def save(self, ckpt_dir: str, step: int, trainable, opt_state) -> None:
        from zonos_tpu_torch.utils.train_state import save_train_state

        if self.tp > 1 and self.specs is not None:
            from zonos_tpu_torch.ops.tp import axis_group
            from zonos_tpu_torch.parallel.sharding import gather_part, map_specs

            group = axis_group(self.mesh, "model")
            state_specs = self._state_specs(trainable, opt_state)
            trainable = self.whole(trainable)
            opt_state = map_specs(lambda t, s: gather_part(t, s, group), opt_state, state_specs)
        if self.mesh is None or self.mesh.get_rank() == 0:
            save_train_state(ckpt_dir, step, trainable, opt_state)

    def restore(self, ckpt_dir: str, trainable, opt_state):
        from zonos_tpu_torch.utils.train_state import restore_train_state

        if self.tp == 1 or self.specs is None:
            return restore_train_state(ckpt_dir, trainable, opt_state)
        from zonos_tpu_torch.ops.tp import axis_rank
        from zonos_tpu_torch.parallel.sharding import local_part, map_specs

        restored = restore_train_state(ckpt_dir, None, None)  # whole, on the host
        if restored is None:
            return None
        step, whole_params, whole_state = restored
        from zonos_tpu_torch.parallel.train import tree_leaves

        r = axis_rank(self.mesh, "model")
        device = tree_leaves(trainable)[0].device

        def cut(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            return local_part(t, spec, r, self.tp).to(device)

        params = map_specs(cut, whole_params, self.specs)
        state = map_specs(cut, whole_state, self._state_specs(trainable, opt_state))
        return step, params, state


if __name__ == "__main__":
    main()
