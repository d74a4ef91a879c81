"""The port's distributed part on the CPU: a world of 4 gloo processes runs
every case of ``tests/_parallel_cases.py`` once (meshes 1x4, 2x2, 4x1; the
tensor-parallel forwards at fp32, int8 and int4; the prefill's CFG logits
under DP 2 x TP 2; greedy generates, the hybrid, streaming, training steps,
sharded checkpoint loads, the dry run, the batcher over a sharded model
and, last, a fault on one follower), and the tests below assert one case
each.  The processes import the port only; the JAX references are computed
here, in this process, while they run.
A ``train_cli --dp 2 --tp 2`` run under torchrun closes the file.

Tolerances: the tensor-parallel forwards ``rtol = atol = 2e-3`` against
JAX's unsharded ``transformer_forward`` (as ``tests/test_parallel.py``);
the bf16 CFG logits ``rtol 0.1, atol 0.15`` (the all-reduce reorders bf16
sums); data-parallel codes and audio bit for bit the unsharded port's; a
training step's loss and parameters within 1e-5 relative of the
one-process step."""

from __future__ import annotations

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import TRANSFORMER_CONFIG_DICT as J_TRANSFORMER
from zonos_tpu.config import ZonosConfig as JaxZonosConfig
from zonos_tpu.models.backbone import KVCache as JaxKVCache
from zonos_tpu.models.backbone import transformer_forward as jax_forward
from zonos_tpu.models.backbone import transformer_prefill as jax_prefill
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.models.tts import apply_heads as jax_heads
from zonos_tpu.models.tts import cfg_blend as jax_blend
from zonos_tpu_torch import Zonos, ZonosConfig
from zonos_tpu_torch.config import TRANSFORMER_CONFIG_DICT
from zonos_tpu_torch.convert import convert_zonos_params

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TINY = {"d_model": 64, "n_layer": 2, "attn_mlp_d_intermediate": 128,
        "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}
TRAIN = {"d_model": 128, "n_layer": 2, "attn_mlp_d_intermediate": 256,
         "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}}


def _dict(backbone: dict, base=J_TRANSFORMER) -> dict:
    d = copy.deepcopy(base)
    d["backbone"].update(copy.deepcopy(backbone))
    return d


def _bf16(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _cond_inputs(specs, B: int, rng) -> dict:
    """An input for every conditioner, as the loader makes them."""
    out = {}
    for s in specs:
        if s.type == "Espeak":
            out[s.name] = rng.integers(4, 60, size=(B, 16)).astype(np.int32)
        elif s.type == "Integer":
            out[s.name] = rng.integers(0, 100, size=(B, 1, 1)).astype(np.int32)
        elif s.type == "Passthrough":
            out[s.name] = rng.normal(size=(B, 1, s.cond_dim)).astype(np.float32)
        else:
            out[s.name] = rng.uniform(s.min_val, s.max_val,
                                      size=(B, 1, s.input_dim)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _inputs() -> tuple[dict, dict]:
    """The processes' inputs (port tensors) and the JAX models they come from."""
    jcfg = JaxZonosConfig.from_dict(_dict(TINY))
    jm = JaxZonos(jcfg, seed=0)
    bf16 = jm.params
    fp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), bf16)
    quantized = {}
    for mode in ("int8", "int4"):
        q = JaxZonos(jcfg, seed=0)
        q.params = fp32
        q.quantize_int8() if mode == "int8" else q.quantize_int4(group_size=32)
        quantized[mode] = q.params
    rng = np.random.default_rng(5)
    port = {name: convert_zonos_params(jax.tree.map(np.asarray, p))
            for name, p in (("bf16", bf16), ("fp32", fp32), *quantized.items())}
    port.update(
        x=torch.from_numpy(rng.normal(size=(2, 6, 64)).astype(np.float32)),
        prefix=_bf16(rng, (4, 4, 64)), prefix8=_bf16(rng, (16, 5, 64)),
        prefix4=_bf16(rng, (8, 5, 64)), hprefix=_bf16(rng, (8, 4, 64)))
    cfg = ZonosConfig.from_dict(_dict(TRAIN, TRANSFORMER_CONFIG_DICT))
    specs = Zonos(cfg, device="cpu", dtype=torch.float32).specs
    codes = torch.from_numpy(rng.integers(0, 1024, size=(4, 9, 16)))
    codes[1, :, 10:] = cfg.masked_token_id  # rows with fewer valid targets than the others
    codes[3, :, 6:] = cfg.masked_token_id
    port["train_batch"] = {"cond_inputs": _cond_inputs(specs, 4, rng), "codes": codes}
    return port, {"jcfg": jcfg, "bf16": bf16, "fp32": fp32, **quantized}


def _jax_refs(port: dict, jax_models: dict) -> dict:
    jcfg = jax_models["jcfg"]
    x = jnp.asarray(port["x"].numpy())
    refs = {mode: np.asarray(jax_forward(jcfg.backbone, jax_models[mode]["backbone"], x),
                             np.float32) for mode in ("fp32", "int8", "int4")}
    prefix = jnp.asarray(port["prefix"].float().numpy(), jnp.bfloat16)
    params = jax_models["bf16"]
    cache = JaxKVCache.create(jcfg.backbone, prefix.shape[0], 16)
    hidden, _ = jax_prefill(jcfg.backbone, params["backbone"], prefix, cache)
    refs["logits"] = np.asarray(jax_blend(jax_heads(params, jcfg, hidden[:, -1]),
                                          jnp.float32(2.0)), np.float32)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the processes once: -> (case -> [result of each rank], JAX refs)."""
    workdir = tmp_path_factory.mktemp("world")
    port, jax_models = _inputs()
    torch.save(port, workdir / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for rank in range(WORLD):
        with open(workdir / f"log.{rank}", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "_parallel_cases.py"), str(rank),
                 str(WORLD), str(workdir / "store"), str(workdir)],
                cwd=workdir, env=env, stdout=log, stderr=subprocess.STDOUT))
    refs = _jax_refs(port, jax_models)  # while the processes run
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    logs = "\n".join((workdir / f"log.{r}").read_text()[-3000:] for r in range(WORLD))
    assert codes == [0] * WORLD, logs
    results: dict = {}
    for path in sorted(workdir.glob("*.*.pt")):
        case, rank = path.name.split(".")[:2]
        results.setdefault(case, {})[int(rank)] = torch.load(path, weights_only=False)
    return results, refs


def _value(world, case: str, rank: int = 0) -> dict:
    results, _ = world
    got = results[case][rank]
    if "error" in got:
        pytest.fail(f"{case} on rank {rank}:\n{got['error']}")
    return got["value"]


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_shapes(world, rank):
    """1x4, 2x2 and 4x1 over the same world; rank = data * n_model + model."""
    got = _value(world, "mesh_shapes", rank)
    for n_data, n_model in ((1, 4), (2, 2), (4, 1)):
        assert got[f"{n_data}x{n_model}"].tolist() == [n_data, n_model, rank // n_model,
                                                      rank % n_model]


@pytest.mark.parametrize("mode", ["fp32", "int8", "int4"])
def test_tensor_parallel_forward_matches_jax(world, mode):
    """TP = 2: the sharded ``transformer_forward`` (wo/w2 summed over the
    model axis; int4's replicated wo/w2 fed the gathered activation) against
    JAX's unsharded forward and the port's own."""
    got = _value(world, f"forward_{mode}")
    ref = world[1][mode]
    np.testing.assert_allclose(got["sharded"], ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["sharded"], got["unsharded"], rtol=2e-3, atol=2e-3)
    assert np.abs(ref).max() > 0.1


def test_prefill_cfg_logits_dp2_tp2(world):
    got = _value(world, "prefill_logits")
    np.testing.assert_allclose(got["sharded"], got["unsharded"], rtol=0.1, atol=0.15)
    np.testing.assert_allclose(got["sharded"], world[1]["logits"], rtol=0.1, atol=0.15)
    assert np.isfinite(got["sharded"]).any()


@pytest.mark.parametrize("rank", range(WORLD))
def test_data_parallel_generate_is_bit_for_bit(world, rank):
    """DP 4: every rank returns all 8 requests, each the unsharded codes;
    the callback saw the whole batch's frame."""
    got = _value(world, "generate_dp4", rank)
    assert len(got["got"]) == len(got["ref"]) == 8
    for name, ref in got["ref"].items():
        np.testing.assert_array_equal(got["got"][name], ref)
    assert [got["ref"][f"row{i}"].shape[1] for i in (1, 4)] == [9, 3]  # the step limits
    assert got["frame"].tolist() == [8, 9, 1]  # the first poll's


def test_dp2_tp2_generate_contract(world):
    ranks = [_value(world, "generate_dp2tp2", r)["got"] for r in range(WORLD)]
    assert len(ranks[0]) == 2
    for codes in ranks[0].values():
        assert codes.shape[0] == 9 and ((codes >= 0) & (codes < 1024)).all()
    for other in ranks[1:]:  # every rank returns the same whole batch
        for name in ranks[0]:
            np.testing.assert_array_equal(other[name], ranks[0][name])


def test_sharded_hybrid_generate(world):
    """TP 2 keeps the contract of tests/test_parallel.py's hybrid shard; DP 4
    gives the unsharded codes bit for bit."""
    got = _value(world, "hybrid")
    for codes in got["tp"].values():
        assert codes.shape[0] == 9 and ((codes >= 0) & (codes < 1024)).all()
    for name, ref in got["ref"].items():
        np.testing.assert_array_equal(got["dp"][name], ref)


def test_sharded_streaming(world):
    """DP 4: each row's streamed samples (its codes, through a stand-in codec
    that writes them out) bit for bit the unsharded stream's; DP 2 x TP 2
    through the codec: finite chunks of every row."""
    got = _value(world, "stream")
    for name, ref in got["ref"].items():
        assert ref.size > 0
        np.testing.assert_array_equal(got["dp"][name], ref)
        assert np.isfinite(got["tp"][name]).all() and got["tp"][name].size > 0


# each step's bound: the gradients 1e-5 of each leaf's largest (a Fourier conditioner's 1e-2,
# as tests/test_torch_port_train.py holds them: its cotangents round through bf16 features);
# Adafactor's updated leaves 1e-5 of each leaf's largest value; AdamW's 1e-4, since its first
# update g / (|g| + eps) moves an entry whose |g| is near eps by a large share of the
# learning rate for a tiny change of g: two one-process AdamW steps that differ only in the
# order of their fp32 sums (1 and 6 torch threads) differ by 6.6e-5 of w1's largest value
TRAIN_BOUNDS = {"grads": (1e-5, 1e-2), "adafactor": (1e-5, 1e-5), "adamw": (1e-4, 1e-4)}


@pytest.mark.parametrize("kind", list(TRAIN_BOUNDS))
def test_dp2_tp2_train_step_matches_one_process(world, kind):
    """fp32, CFG dropout from one seed, rows of unequal valid counts
    (Adafactor with 2 micro-batches), every leaf moved off its init: the
    loss within 1e-5 relative of the one-process step on the same whole
    batch, and the gradients (``grads``: an optimizer that passes them on)
    and each optimizer's updated leaves within ``TRAIN_BOUNDS`` of them."""
    got = _value(world, f"train_{kind}")
    loss, ref = got["loss"]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    rest, fourier = TRAIN_BOUNDS[kind]
    assert float(got["rel_err"]) <= rest
    assert float(got["fourier_rel_err"]) <= fourier


@pytest.mark.parametrize("rank", range(WORLD))
def test_checkpoint_loads_this_ranks_shard(world, rank):
    got = _value(world, "checkpoint", rank)
    assert got["equal"].all() and got["equal"].size > 10
    assert got["wqkv"].tolist() == [2, 64, 64]  # (4 + 2 * 2) * 16 / 2 columns
    assert bool(got["from_local"])


def test_dryrun_4(world):
    assert bool(_value(world, "dryrun")["ok"])


@pytest.mark.parametrize("mode", ["sync", "stream"])
def test_batcher_over_data_parallel_model(world, mode):
    """Rank 0's batcher over a DP 4 model, the other ranks following: the
    outputs (codes written out by a stand-in codec) bit for bit the unsharded
    batcher's, a sync batch and a streaming group (tests/test_serving.py:702)."""
    got = _value(world, "batcher")
    ref, ours = got[mode + "_ref"], got[mode]
    n = len(ref) - 1
    for i in range(n):
        assert ref[f"row{i}"].size > 0
        np.testing.assert_array_equal(ours[f"row{i}"], ref[f"row{i}"])
    max_batch, completed, failed = ours[f"row{n}"].tolist()
    assert (completed, failed) == (n, 0) and max_batch == n
    assert ours[f"row{n}"].tolist() == ref[f"row{n}"].tolist()


def test_a_follower_fault_fails_the_requests_and_ends_the_world(world):
    """A DP 4 model whose generate raises on rank 3 alone (the others left
    inside the call's collectives): rank 0's request fails with an error,
    and a later one at once; each follower's ``follow`` raises; every rank
    leaves the world, none after waiting out its 120-s timeout."""
    lead = _value(world, "follower_fails", 0)
    first, later = lead["errors"]
    assert first and "took its world of processes down" in later
    assert lead["failed"] == 2 and lead["left"] and lead["s"] < 100
    for rank in range(1, WORLD):
        got = _value(world, "follower_fails", rank)
        assert got["raised"] and got["left"] and got["s"] < 100
    assert "a fault on rank 3" in _value(world, "follower_fails", 3)["raised"]


def test_train_cli_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc_per_node 4 -m
    zonos_tpu_torch.apps.train_cli --dp 2 --tp 2``: two steps on the tiny
    model, a checkpoint of the whole parameters and an export that loads."""
    from zonos_tpu_torch.audio.io import save_audio
    from zonos_tpu_torch.speaker_db import hash_audio_file

    root = tmp_path / "ljs"
    (root / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        wav = 0.3 * np.sin(2 * np.pi * (110 + 50 * i) * np.arange(2000 + 256 * i) / 8000.0)
        path = root / "wavs" / f"clip{i}.wav"
        save_audio(str(path), wav.astype(np.float32), 8000)
        rows.append(f"clip{i}|Hello number {i}.|Hello number {i}.")
        # the codes cache, filled ahead: the run encodes nothing
        h = hash_audio_file(str(path))
        entry = tmp_path / "cache" / "dac44k-torch" / h[:1] / f"{h}.npy"
        entry.parent.mkdir(parents=True, exist_ok=True)
        np.save(entry, rng.integers(0, 1024, size=(9, 12 + i)).astype(np.int32))
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "4", "-m", "zonos_tpu_torch.apps.train_cli", "--ljspeech", str(root), "--tiny",
           "--device", "cpu", "--dp", "2", "--tp", "2", "--batch", "2", "--steps", "2",
           "--lr", "1e-3", "--warmup", "0", "--log_every", "1", "--optimizer", "adafactor",
           "--cache_dir", str(tmp_path / "cache"), "--ckpt_dir", str(tmp_path / "ck"),
           "--phoneme_bucket", "16", "--code_bucket", "8", "--export", str(tmp_path / "ref")]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "mesh: {'data': 2, 'model': 2}" in res.stderr and "0 fresh encodes" in res.stderr
    assert res.stderr.count("step 2  loss") == 1  # rank 0 alone logs
    state = torch.load(tmp_path / "ck" / "2" / "state.pt", weights_only=True)
    assert state["params"]["backbone"]["layers"]["wqkv"].shape == (2, 64, 128)  # whole
    m = Zonos.from_local(str(tmp_path / "ref" / "config.json"),
                         str(tmp_path / "ref" / "model.safetensors"), device="cpu")
    assert torch.equal(m.params["backbone"]["layers"]["w1"],
                       state["params"]["backbone"]["layers"]["w1"].to(torch.bfloat16))
