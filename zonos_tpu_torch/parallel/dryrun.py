"""Multi-process dry run (zonos_tpu/parallel/dryrun.py): one sharded training
step, a sharded generate, a sharded streaming decode, a sharded hybrid
generate and the continuous batcher over the sharded model, on a mesh of n
processes at tiny widths with random weights.

The mesh is ``(n/2, 2)`` when n is even, else ``(n, 1)``, as JAX's.  Called
inside a world of n processes (torchrun, or a test's processes), every rank
calls :func:`run_dryrun` and it runs there; called outside one, it spawns n
processes on the CPU over gloo (a file store in a temporary directory) and
runs in each.  Streaming and the batcher vocode with a small codec
(ratios 8, 8, 8: the full hop of 512, narrow widths), not the 44.1 kHz DAC.

    python -m zonos_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

SMALL_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(8, 8, 8), decoder_hidden_size=32)


def _tiny_transformer():
    from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT, ZonosConfig

    d = copy.deepcopy(TRANSFORMER_CONFIG_DICT)
    d["backbone"].update({"d_model": 128, "n_layer": 2, "attn_mlp_d_intermediate": 256,
                          "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}})
    return ZonosConfig.from_dict(d)


def _tiny_hybrid():
    from zonos_tpu_torch.config import HYBRID_CONFIG_DICT, ZonosConfig

    d = copy.deepcopy(HYBRID_CONFIG_DICT)
    d["backbone"].update({
        "d_model": 64, "n_layer": 4, "attn_layer_idx": [1, 3], "attn_mlp_d_intermediate": 128,
        "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "expand": 2, "headdim": 16},
        "attn_cfg": {"num_heads": 4, "num_heads_kv": 2, "head_dim": 16, "rotary_emb_dim": 8},
    })
    return ZonosConfig.from_dict(d)


def run_dryrun(n_devices: int, device: str | torch.device = "cpu") -> None:
    """The dry run on ``n_devices`` processes (module docstring); ``device``
    is this rank's device inside a world (the CPU where it spawns)."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a dry run of {n_devices} inside a world of "
                             f"{dist.get_world_size()}")
        _body(n_devices, torch.device(device))
        return
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_spawned, args=(n_devices, os.path.join(tmp, "store")),
                                    nprocs=n_devices)


def _spawned(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        _body(world, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _body(n: int, device: torch.device) -> None:
    from zonos_tpu_torch.conditioning import make_cond_dict
    from zonos_tpu_torch.models.dac import DACAutoencoder
    from zonos_tpu_torch.models.dac.codec import DACConfig, init_dac_params
    from zonos_tpu_torch.models.tts import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.parallel.followers import follow
    from zonos_tpu_torch.ops.tp import mesh_shape
    from zonos_tpu_torch.parallel.mesh import make_mesh
    from zonos_tpu_torch.parallel.sharding import zonos_param_specs
    from zonos_tpu_torch.parallel.train import make_optimizer, make_train_step
    from zonos_tpu_torch.serving import ContinuousBatcher, TTSRequest

    n_model = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // n_model, n_model, device)
    shape = mesh_shape(mesh)
    greedy = SamplingParams.greedy()

    cfg = _tiny_transformer()
    model = Zonos(cfg, seed=0, device=device).shard(mesh)
    dac_cfg = DACConfig(**SMALL_DAC)
    model._autoencoder = DACAutoencoder(
        params=init_dac_params(dac_cfg, torch.Generator(device=device).manual_seed(0), device),
        cfg=dac_cfg, device=device)

    # one sharded training step: the batch split on "data", the weights on "model"
    B = shape["data"] * 2  # 2 samples a data rank
    Lc, T, d = 8, 12, cfg.backbone.d_model
    gen = torch.Generator().manual_seed(0)
    cond = torch.randn((B, Lc, d), generator=gen).to(device, model.compute_dtype)
    codes = torch.as_tensor(np.random.default_rng(0).integers(0, 1024, (B, 9, T))).to(device)
    optimizer = make_optimizer(mesh=mesh, specs=zonos_param_specs(model.params, cfg))
    step = make_train_step(cfg, optimizer, mesh=mesh)
    params, _, loss = step(model.params, optimizer.init(model.params), cond, codes)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")
    _say(f"dryrun ok: {n} processes, mesh {shape}, loss {loss:.3f}")

    # the sharded generate on the trained shard
    model.params = params
    prefix = torch.cat([cond, cond])
    out = model.generate(prefix, batch_size=B, max_new_tokens=4, seed=1, sampling_params=greedy,
                         progress_bar=False)
    if len(out) != B or any(o.shape[0] != 9 for o in out):
        raise AssertionError(f"sharded generate returned {[o.shape for o in out]}")

    # the sharded streaming decode: chunks of steps, each vocoded, rows on "data"
    events = []
    for ev in model.stream_generate_batch(prefix, max_new_tokens=12, chunk_frames=6,
                                          margin_frames=16, batch_size=B, sampling_params=greedy):
        events.extend(ev)
    if not events or not all(np.isfinite(w).all() for _, w in events):
        raise AssertionError("sharded streaming gave no finite chunk")
    _say(f"dryrun streaming ok: {len(events)} chunk events, batch {B} on the data axis")

    # the hybrid: attention and MLP on "model", the Mamba2 mixers replicated
    hyb = Zonos(_tiny_hybrid(), seed=0, device=device).shard(mesh)
    hcond = torch.randn((2 * B, 6, 64), generator=gen).to(device, hyb.compute_dtype)
    out = hyb.generate(hcond, batch_size=B, max_new_tokens=6, seed=0, sampling_params=greedy,
                       progress_bar=False)
    if len(out) != B or any(o.shape[0] != 9 for o in out):
        raise AssertionError(f"sharded hybrid generate returned {[o.shape for o in out]}")
    _say(f"dryrun hybrid ok: sharded Mamba2+attention generate, batch {B}, mesh {shape}")

    # the continuous batcher on rank 0, every other rank following its calls
    if dist.get_rank() != 0:
        follow(model)
        return
    batcher = ContinuousBatcher(model, max_batch=4, max_wait_ms=500.0, cond_pad_multiple=16,
                                batch_buckets=(2, 4))
    try:
        spk = np.zeros((1, 1, 128), np.float32)
        pendings = [batcher.submit(TTSRequest(
            cond_dict=make_cond_dict(text=f"sharded serving {i}", speaker=spk),
            sampling=greedy, seed=i, max_new_tokens=10)) for i in range(2)]
        wavs = [p.wait(timeout=900) for p in pendings]
        snap = batcher.snapshot()
    finally:
        batcher.close()
    if not all(w.shape[-1] > 0 and np.isfinite(w).all() for w in wavs):
        raise AssertionError("the sharded batcher returned an empty or non-finite waveform")
    if snap["completed"] != 2 or snap["failed"] != 0:
        raise AssertionError(f"the sharded batcher's counts: {snap}")
    _say(f"dryrun batcher ok: {len(wavs)} sharded serving requests, "
         f"max_batch_seen {snap['max_batch_seen']}")


if __name__ == "__main__":
    run_dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
