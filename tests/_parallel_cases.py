"""The processes of ``tests/test_torch_port_parallel.py``: one rank of a world
of gloo processes on the CPU, which runs every case in turn at tiny widths
and writes each case's arrays (or its error) to ``<workdir>/<case>.<rank>.pt``.
It imports torch, numpy and the port only.

    python tests/_parallel_cases.py RANK WORLD STORE_FILE WORKDIR
"""

from __future__ import annotations

import copy
import datetime
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch.conditioning import make_cond_dict
from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.models.backbone import KVCache, transformer_forward, transformer_prefill
from zonos_tpu_torch.models.dac import DACAutoencoder
from zonos_tpu_torch.models.dac.codec import DACConfig, init_dac_params
from zonos_tpu_torch.models.tts import apply_heads, cfg_blend
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.parallel import follow, make_mesh, mesh_shape, run_dryrun
from zonos_tpu_torch.ops.tp import axis_group, axis_rank, model_axis
from zonos_tpu_torch.parallel.sharding import shard_params, unshard_params, zonos_param_specs
from zonos_tpu_torch.parallel.train import (
    Optimizer,
    make_conditioned_train_step,
    make_optimizer,
    tree_flatten,
)
from zonos_tpu_torch.serving import ContinuousBatcher, StreamRequest, TTSRequest
from zonos_tpu_torch.utils.checkpoint import export_zonos_checkpoint, load_zonos_checkpoint

SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)
GREEDY = SamplingParams.greedy()
TINY = {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
        "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
# d_model 128: every matrix has two axes of 128 or more, so Adafactor factors them
TRAIN = {"d_model": 128, "n_layer": 2, "attn_mlp_d_intermediate": 256,
         "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
HYBRID = {"d_model": 64, "n_layer": 4, "attn_layer_idx": [1, 3], "attn_mlp_d_intermediate": 128,
          "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16},
          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16, "rotary_emb_dim": 8}}


def small_dac() -> DACAutoencoder:
    """A seed-0 codec with the full hop of 512 at narrow widths."""
    cfg = DACConfig(**SMALL_DAC)
    return DACAutoencoder(params=init_dac_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                          cfg=cfg, device="cpu")


class CodesVocoder:
    """A stand-in codec whose waveform holds the codes: frame f of row r is
    ``hop`` samples, the first K of them its K codes (exact in fp32).  So
    a stream's audio is compared bit for bit without the convolutions of a
    codec, whose sums on the CPU follow the number of rows decoded together."""

    hop, receptive_field_frames = 512, 12

    def decode(self, codes) -> np.ndarray:
        codes = np.asarray(codes)
        R, K, T = codes.shape
        wav = np.zeros((R, 1, T, self.hop), np.float32)
        wav[:, 0, :, :K] = codes.transpose(0, 2, 1)
        return wav.reshape(R, 1, T * self.hop)

    def codes_to_wavs(self, codes: list) -> list:
        return [self.decode(c[None])[0] for c in codes]


def config(backbone: dict, base=TRANSFORMER_CONFIG_DICT) -> ZonosConfig:
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(backbone))
    return ZonosConfig.from_dict(d)


class Ctx:
    def __init__(self, rank: int, world: int, workdir: Path):
        self.rank, self.world, self.workdir = rank, world, workdir
        self.inputs = torch.load(workdir / "inputs.pt", weights_only=True)

    def model(self, params_key: str | None = None, backbone=TINY, base=TRANSFORMER_CONFIG_DICT,
              dtype=torch.bfloat16) -> Zonos:
        params = None if params_key is None else copy.deepcopy(self.inputs[params_key])
        m = Zonos(config(backbone, base), params=params, seed=0, device="cpu", dtype=dtype)
        m._autoencoder = small_dac()
        return m


# ---------------------------------------------------------------------------
# Cases: each returns a dict of arrays (what the parent asserts)
# ---------------------------------------------------------------------------


def case_mesh_shapes(ctx: Ctx) -> dict:
    out = {}
    for n_data, n_model in ((1, 4), (2, 2), (4, 1)):
        mesh = make_mesh(n_data, n_model)
        out[f"{n_data}x{n_model}"] = np.asarray(
            [mesh_shape(mesh)["data"], mesh_shape(mesh)["model"], axis_rank(mesh, "data"),
             axis_rank(mesh, "model")])
    return out


def _forward(ctx: Ctx, key: str) -> dict:
    """The TP = 2 forward of x on the (2, 2) mesh, and the unsharded one."""
    cfg = config(TINY)
    mesh = make_mesh(2, 2)
    params = ctx.inputs[key]
    x = ctx.inputs["x"]
    ref = transformer_forward(cfg.backbone, params["backbone"], x)
    shard = shard_params(mesh, params, cfg)
    with torch.no_grad(), model_axis(axis_group(mesh, "model")):
        got = transformer_forward(cfg.backbone, shard["backbone"], x)
    return {"sharded": got.float().numpy(), "unsharded": ref.float().numpy()}


def case_forward_fp32(ctx):
    return _forward(ctx, "fp32")


def case_forward_int8(ctx):
    return _forward(ctx, "int8")


def case_forward_int4(ctx):
    return _forward(ctx, "int4")


def case_prefill_logits(ctx: Ctx) -> dict:
    """DP 2 x TP 2: the prefill's CFG logits of a bf16 model."""
    cfg = config(TINY)
    mesh = make_mesh(2, 2)
    prefix = ctx.inputs["prefix"]
    B = prefix.shape[0] // 2

    def logits(params):
        cache = KVCache.create(cfg.backbone, 2 * B, 16)
        hidden, _ = transformer_prefill(cfg.backbone, params["backbone"], prefix, cache)
        return cfg_blend(apply_heads(params, cfg, hidden[:, -1]), 2.0).numpy()

    params = ctx.inputs["bf16"]
    ref = logits(params)
    with torch.no_grad(), model_axis(axis_group(mesh, "model")):
        got = logits(shard_params(mesh, params, cfg))
    return {"sharded": got, "unsharded": ref}


def _codes(outs) -> dict:
    return {f"row{i}": c for i, c in enumerate(outs)}


def case_generate_dp4(ctx: Ctx) -> dict:
    """DP 4: greedy codes of 8 requests with their own step limits, and of
    the unsharded model."""
    prefix = ctx.inputs["prefix8"]
    kw = dict(batch_size=8, max_new_tokens=40, seed=11, sampling_params=GREEDY,
              progress_bar=False, step_limits=[40, 9, 40, 17, 3, 40, 12, 40])
    frames = []
    ref = ctx.model().generate(prefix, **kw)
    model = ctx.model().shard(make_mesh(4, 1))
    got = model.generate(prefix, callback=lambda f, d, t: frames.append(f.shape) or True, **kw)
    return {"ref": _codes(ref), "got": _codes(got), "frame": np.asarray(frames[0])}


def case_generate_dp2tp2(ctx: Ctx) -> dict:
    prefix = ctx.inputs["prefix"]
    model = ctx.model().shard(make_mesh(2, 2))
    got = model.generate(prefix, batch_size=2, max_new_tokens=6, seed=3, sampling_params=GREEDY,
                         progress_bar=False)
    return {"got": _codes(got)}


def case_hybrid(ctx: Ctx) -> dict:
    """The sharded hybrid: its contract at TP 2 (1 x 2 on half the world
    is not a mesh of it, so DP 2 x TP 2), bit for bit at DP 4."""
    prefix = ctx.inputs["hprefix"]
    kw = dict(batch_size=4, max_new_tokens=10, seed=0, sampling_params=GREEDY, progress_bar=False)
    ref = ctx.model(backbone=HYBRID, base=HYBRID_CONFIG_DICT).generate(prefix, **kw)
    tp = ctx.model(backbone=HYBRID, base=HYBRID_CONFIG_DICT).shard(make_mesh(2, 2))
    dp = ctx.model(backbone=HYBRID, base=HYBRID_CONFIG_DICT).shard(make_mesh(4, 1))
    return {"ref": _codes(ref), "tp": _codes(tp.generate(prefix, **kw)),
            "dp": _codes(dp.generate(prefix, **kw))}


def _stream(model, prefix, B) -> list:
    rows: dict[int, list] = {}
    for events in model.stream_generate_batch(prefix, max_new_tokens=40, chunk_frames=8,
                                              margin_frames=16, batch_size=B, seed=5,
                                              sampling_params=GREEDY,
                                              step_limits=[40, 20, 33, 40][:B]):
        for row, wav in events:
            rows.setdefault(row, []).append(wav)
    return [np.concatenate(rows.get(i, [np.zeros(0, np.float32)])) for i in range(B)]


def case_stream(ctx: Ctx) -> dict:
    """The sharded streaming decode: DP 4 bit for bit the unsharded one (its
    codes, through :class:`CodesVocoder`); DP 2 x TP 2 through the codec."""
    prefix = ctx.inputs["prefix4"]
    ref, dp = ctx.model(), ctx.model().shard(make_mesh(4, 1))
    ref._autoencoder = dp._autoencoder = CodesVocoder()
    tp = _stream(ctx.model().shard(make_mesh(2, 2)), prefix, 4)
    return {"ref": _codes(_stream(ref, prefix, 4)), "dp": _codes(_stream(dp, prefix, 4)),
            "tp": _codes(tp)}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _paths(v, path + (i,))]
    return [path]


def _train(ctx: Ctx, kind: str, accum: int) -> dict:
    """One DP 2 x TP 2 step against the one-process step on the same whole
    batch (fp32), with CFG dropout from one seed and rows of unequal valid
    counts.  ``kind`` "grads": an optimizer that passes the gradients on as
    the updates, so the step's change is its gradient."""
    cfg = config(TRAIN)
    model = Zonos(cfg, seed=0, device="cpu", dtype=torch.float32)
    # every leaf moved off its init, whose zero biases would make such a leaf's scale its
    # first update
    gen = torch.Generator().manual_seed(3)
    leaves, rebuild = tree_flatten(model.params)
    model.params = rebuild([t + 0.05 * torch.randn(t.shape, generator=gen) if t is not None
                            and t.is_floating_point() else t for t in leaves])
    specs = model.specs
    batch = ctx.inputs["train_batch"]

    def run(mesh, params, opt_specs):
        opt = (Optimizer(lambda p: {}, lambda g, state, p: (g, state)) if kind == "grads" else
               make_optimizer(mesh=mesh, specs=opt_specs, lr=1e-3, warmup_steps=0,
                              grad_clip=0.5, kind=kind))
        step = make_conditioned_train_step(cfg, specs, opt, uncond_p=0.5, accum_steps=accum,
                                           mesh=mesh)
        gen = torch.Generator().manual_seed(7)
        new, state, loss = step(params, opt.init(params), batch["cond_inputs"], batch["codes"],
                                gen)
        return new, float(loss)

    ref, ref_loss = run(None, model.params, None)
    mesh = make_mesh(2, 2)
    shard = shard_params(mesh, model.params, cfg)
    new, loss = run(mesh, shard, zonos_param_specs(shard, cfg))
    whole = unshard_params(mesh, new, cfg)
    # the Fourier conditioners' leaves get their gradients through bf16 features
    fourier = {s.name for s in specs if s.type == "Fourier"}
    errs = {"fourier": 0.0, "rest": 0.0}
    for path, x, y, p in zip(_paths(ref), tree_flatten(whole)[0], tree_flatten(ref)[0],
                             tree_flatten(model.params)[0]):
        if x is None:
            continue
        if kind == "grads":
            x, y = x - p, y - p
        err = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        key = "fourier" if path[0] == "prefix_conditioner" and path[1] in fourier else "rest"
        errs[key] = max(errs[key], err)
    return {"loss": np.asarray([loss, ref_loss]), "rel_err": np.asarray(errs["rest"]),
            "fourier_rel_err": np.asarray(errs["fourier"])}


def case_train_grads(ctx):
    return _train(ctx, "grads", 1)


def case_train_adamw(ctx):
    return _train(ctx, "adamw", 1)


def case_train_adafactor(ctx):
    return _train(ctx, "adafactor", 2)


def case_checkpoint(ctx: Ctx) -> dict:
    """``load_zonos_checkpoint(mesh=)`` against ``shard_params`` of the whole
    load, and ``Zonos.from_local(mesh=)``."""
    cfg = config(TINY)
    mesh = make_mesh(2, 2)
    path = ctx.workdir / "ckpt"
    if ctx.rank == 0:
        export_zonos_checkpoint(cfg, Zonos(cfg, seed=0, device="cpu").params, str(path))
    dist.barrier()
    model = str(path / "model.safetensors")
    ours = load_zonos_checkpoint(cfg, model, "cpu", mesh=mesh)
    ref = shard_params(mesh, load_zonos_checkpoint(cfg, model, "cpu"), cfg)
    pairs = list(zip(tree_flatten(ours)[0], tree_flatten(ref)[0]))
    loaded = Zonos.from_local(str(path / "config.json"), model, device="cpu", mesh=mesh)
    return {"equal": np.asarray([torch.equal(a, b) and a.dtype == b.dtype for a, b in pairs]),
            "wqkv": np.asarray(ours["backbone"]["layers"]["wqkv"].shape),
            "from_local": np.asarray(torch.equal(
                loaded.params["backbone"]["layers"]["wqkv"], ours["backbone"]["layers"]["wqkv"]))}


def case_dryrun(ctx: Ctx) -> dict:
    run_dryrun(ctx.world)
    return {"ok": np.asarray(True)}


def _serve(ctx: Ctx, model, stream: bool) -> list:
    texts = ["sharded serving one", "sharded serving two", "sharded serving three"]
    if stream:
        texts = texts[:2]
    batcher = ContinuousBatcher(model, max_batch=4, max_wait_ms=500.0, cond_pad_multiple=16,
                                batch_buckets=(4,))
    spk = [np.random.default_rng(i).normal(size=(1, 1, 128)).astype(np.float32)
           for i in range(3)]
    try:
        if stream:
            handles = [batcher.submit_stream(StreamRequest(
                cond_dict=make_cond_dict(text=t, speaker=spk[i]), sampling=GREEDY, seed=101 * i,
                max_new_tokens=18, chunk_frames=8, margin_frames=16))
                for i, t in enumerate(texts)]
            outs = [np.concatenate(list(h.chunks(timeout=600))) for h in handles]
        else:
            pendings = [batcher.submit(TTSRequest(
                cond_dict=make_cond_dict(text=t, speaker=spk[i]), sampling=GREEDY,
                seed=101 * i, max_new_tokens=18)) for i, t in enumerate(texts)]
            outs = [p.wait(timeout=600) for p in pendings]
        snap = batcher.snapshot()
    finally:
        batcher.close()
    return outs + [np.asarray([snap["max_batch_seen"], snap["completed"], snap["failed"]])]


def case_batcher(ctx: Ctx) -> dict:
    """The batcher over a DP 4 model against the unsharded batcher, a sync
    batch and a streaming group: requests reach rank 0, the others follow."""
    sharded, ref = ctx.model().shard(make_mesh(4, 1)), ctx.model()
    sharded._autoencoder = ref._autoencoder = CodesVocoder()
    out = {}
    for stream in (False, True):
        name = "stream" if stream else "sync"
        if ctx.rank != 0:
            follow(sharded)
            continue
        out[name + "_ref"] = _codes(_serve(ctx, ref, stream))
        out[name] = _codes(_serve(ctx, sharded, stream))
    return out


def case_follower_fails(ctx: Ctx) -> dict:
    """Last, since it takes the world down: the batcher over a DP 4 model
    whose ``generate`` raises on rank 3 alone, before the call's first
    collective, while the other ranks go on into it.  Rank 0's request gets
    an error, and a later one too; every follower's ``follow`` raises; every
    rank has left the world; none waited out the world's 120-s timeout."""
    model = ctx.model().shard(make_mesh(4, 1))
    model._autoencoder = CodesVocoder()
    if ctx.rank == 3:
        def broken(*args, **kwargs):
            raise RuntimeError("a fault on rank 3")

        model.generate = broken
    t0 = time.perf_counter()
    if ctx.rank != 0:
        try:
            follow(model)
            raised = ""
        except Exception as e:  # noqa: BLE001 — what the parent asserts
            raised = repr(e)
        return {"raised": raised, "left": not dist.is_initialized(),
                "s": time.perf_counter() - t0}
    batcher = ContinuousBatcher(model, max_batch=4, max_wait_ms=100.0, cond_pad_multiple=16,
                                batch_buckets=(4,))
    spk = np.zeros((1, 1, 128), np.float32)
    errors = []
    try:
        for i in range(2):
            pending = batcher.submit(TTSRequest(
                cond_dict=make_cond_dict(text=f"a fault {i}", speaker=spk), sampling=GREEDY,
                seed=i, max_new_tokens=8))
            try:
                pending.wait(timeout=300)
                errors.append("")
            except Exception as e:  # noqa: BLE001 — what the parent asserts
                errors.append(repr(e))
        failed = batcher.snapshot()["failed"]
    finally:
        batcher.close()
    return {"errors": errors, "failed": failed, "left": not dist.is_initialized(),
            "s": time.perf_counter() - t0}


CASES = [name[5:] for name in list(globals()) if name.startswith("case_")]


def main(rank: int, world: int, store: str, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    ctx = Ctx(rank, world, Path(workdir))
    for name in CASES:
        try:
            result = {"value": globals()["case_" + name](ctx)}
        except Exception:  # noqa: BLE001 — written for the parent to report
            result = {"error": traceback.format_exc()}
        torch.save(result, Path(workdir) / f"{name}.{rank}.pt")
        if dist.is_initialized():  # the last case leaves the world
            dist.barrier()
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
