"""Reference-format checkpoints in the port, held against the JAX package on
the CPU: the port's own safetensors reader and writer against the
``safetensors`` package, ``Zonos.from_local`` of both packages on one file
(the tiny transformer and hybrid of tests/test_fake_checkpoint_parity.py),
exports that load in the other package, the hybrid's ``Wqkv`` alias, the DAC
from an HF ``DacModel`` state dict, and the local-only hub lookup.

Leaves are compared in bf16 bits, as both loaders cast every leaf to bf16
by default.  Greedy codes are compared on fp32 loads of the same file: with
bf16 weights each package's rounding of intermediate values differs (XLA
keeps excess precision inside fusions), and a tiny random model's greedy
codes in bf16 differ from its own fp32 codes in either package.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fake_checkpoint_parity import (
    _fake_sd_hybrid,
    _fake_sd_transformer,
    _tiny_hybrid_cfg,
    _tiny_transformer_cfg,
)
from zonos_tpu.conditioning import make_cond_dict as jax_make_cond_dict
from zonos_tpu.models.tts import Zonos as JaxZonos
from zonos_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from zonos_tpu.utils.checkpoint import config_to_reference_dict as jax_config_dict
from zonos_tpu.utils.checkpoint import export_zonos_checkpoint as jax_export
from zonos_tpu.utils.checkpoint import load_zonos_checkpoint as jax_load
from zonos_tpu_torch import Zonos, ZonosConfig, make_cond_dict
from zonos_tpu_torch.models.dac import DACAutoencoder
from zonos_tpu_torch.models.dac.codec import DACConfig, dac_decode
from zonos_tpu_torch.models.dac.convert import convert_dac_state_dict, export_dac_state_dict
from zonos_tpu_torch.models.hybrid import convert_hybrid_backbone
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.utils.checkpoint import (
    _Put,
    export_zonos_checkpoint,
    load_safetensors,
    save_safetensors,
    safetensors_metadata,
)
from zonos_tpu_torch.utils.hub import hub_download

GREEDY_FRAMES = 24
SPEAKER = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)
TEXT = "Hello world."


def _bits(x) -> np.ndarray:
    """A bf16 leaf's bits as uint16 (a JAX array or a torch tensor)."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16, x.dtype
        return x.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    assert a.dtype.name == "bfloat16", a.dtype
    return a.view(np.uint16)


def _pairs(jtree, ttree, path=""):
    """(path, JAX leaf, port leaf) over the JAX tree; the trees must have the
    same keys."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), (path, set(jtree) ^ set(ttree))
        for k in jtree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, jtree, ttree


def _assert_same_bf16_leaves(jparams, tparams) -> int:
    n = 0
    for path, a, b in _pairs(jparams, tparams):
        assert tuple(np.shape(a)) == tuple(b.shape), path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
        n += 1
    return n


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def _mixed_tensors() -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "f16": torch.randn((7,), generator=g).to(torch.float16),
        "f32": torch.randn((2, 3, 4), generator=g),
        "i64": torch.randint(-2**40, 2**40, (5,), generator=g),
        "i32": torch.randint(-2**30, 2**30, (3, 1), generator=g, dtype=torch.int32),
        "empty": torch.zeros((0, 4)),
        "scalar": torch.tensor(3.5),
    }


def test_safetensors_reads_the_package_files(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    tensors = _mixed_tensors()
    path = str(tmp_path / "pkg.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    got = load_safetensors(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].view(-1).view(torch.uint8) if t.numel() else got[k],
                           t.view(-1).view(torch.uint8) if t.numel() else t), k
    assert safetensors_metadata(path) == {"format": "pt", "note": "x"}


def test_safetensors_package_reads_the_port_files(tmp_path):
    st = pytest.importorskip("safetensors")
    st_torch = pytest.importorskip("safetensors.torch")
    tensors = _mixed_tensors()
    path = str(tmp_path / "port.safetensors")
    save_safetensors(path, tensors, metadata={"format": "pt"})
    got = st_torch.load_file(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    with st.safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    # and the port's reader reads its own file back
    back = load_safetensors(path)
    assert all(torch.equal(back[k], t) for k, t in tensors.items())


def test_hub_download_reads_only_local_files(tmp_path, monkeypatch):
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "org/repo/config.json")):
        hub_download("org/repo", "config.json")
    (tmp_path / "org/repo").mkdir(parents=True)
    (tmp_path / "org/repo/config.json").write_text("{}")
    assert hub_download("org/repo", "config.json") == str(tmp_path / "org/repo/config.json")


# ---------------------------------------------------------------------------
# Zonos.from_local in both packages
# ---------------------------------------------------------------------------

KINDS = {"transformer": (_tiny_transformer_cfg, _fake_sd_transformer),
         "hybrid": (_tiny_hybrid_cfg, _fake_sd_hybrid)}


@pytest.fixture(scope="module", params=list(KINDS))
def checkpoint(request, tmp_path_factory):
    """A reference-named fp32 checkpoint written by ``safetensors.numpy``,
    and both packages' ``from_local`` of it."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    make_cfg, make_sd = KINDS[request.param]
    jcfg = make_cfg()
    out = tmp_path_factory.mktemp(request.param)
    st_numpy.save_file(make_sd(jcfg), str(out / "model.safetensors"))
    (out / "config.json").write_text(json.dumps(jax_config_dict(jcfg)))
    cfg_path, model_path = str(out / "config.json"), str(out / "model.safetensors")
    jm = JaxZonos.from_local(cfg_path, model_path)
    tm = Zonos.from_local(cfg_path, model_path, device="cpu")
    return request.param, jcfg, cfg_path, model_path, jm, tm


def test_from_local_gives_jax_leaves(checkpoint):
    kind, _, _, _, jm, tm = checkpoint
    n = _assert_same_bf16_leaves(jm.params, tm.params)
    assert n == len(jax.tree.leaves(jm.params))
    if kind == "hybrid":  # cast like every other leaf, as the JAX loader casts them
        mamba = tm.params["backbone"]["layers_list"][0]
        assert {mamba[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.bfloat16}
        assert not torch.equal(mamba["A_log"], torch.zeros_like(mamba["A_log"]))


def test_from_local_greedy_codes_match_jax(checkpoint):
    """fp32 loads of one file through each package's loader: the same
    greedy codes, 24 frames at CFG 2."""
    _, jcfg, cfg_path, model_path, jm, _ = checkpoint
    jm32 = JaxZonos(jcfg)
    jm32.params = jax_load(jcfg, model_path, dtype=jnp.float32)
    tm32 = Zonos.from_local(cfg_path, model_path, device="cpu", dtype=torch.float32)
    assert tm32.compute_dtype == torch.float32
    jp = jm32.prepare_conditioning(jax_make_cond_dict(text=TEXT, speaker=SPEAKER))
    tp = tm32.prepare_conditioning(make_cond_dict(text=TEXT, speaker=SPEAKER))
    ref = jm32.generate(jp, max_new_tokens=GREEDY_FRAMES, cfg_scale=2.0,
                        sampling_params=JaxSamplingParams.greedy(), progress_bar=False)
    ours = tm32.generate(tp, max_new_tokens=GREEDY_FRAMES, cfg_scale=2.0,
                         sampling_params=SamplingParams.greedy())
    assert ours[0].shape == ref[0].shape and ours[0].shape[1] > 0
    np.testing.assert_array_equal(ours[0], ref[0])


def test_port_export_loads_in_jax_and_back(checkpoint, tmp_path):
    _, jcfg, _, _, jm, tm = checkpoint
    path = export_zonos_checkpoint(tm.config, tm.params, str(tmp_path / "port"))
    cfg = ZonosConfig.from_json(str(tmp_path / "port" / "config.json"))
    assert cfg == tm.config
    _assert_same_bf16_leaves(jax_load(jcfg, path), tm.params)
    back = Zonos.from_local(str(tmp_path / "port" / "config.json"), path, device="cpu")
    _assert_same_bf16_leaves(jm.params, back.params)


def test_jax_export_loads_in_the_port(checkpoint, tmp_path):
    pytest.importorskip("safetensors.torch")
    _, jcfg, _, _, jm, _ = checkpoint
    path = jax_export(jcfg, jm.params, str(tmp_path / "jax"))
    back = Zonos.from_local(str(tmp_path / "jax" / "config.json"), path, device="cpu")
    _assert_same_bf16_leaves(jm.params, back.params)


def test_from_pretrained_reads_the_models_dir(checkpoint, tmp_path, monkeypatch):
    _, _, cfg_path, model_path, jm, _ = checkpoint
    repo = tmp_path / "Zyphra" / "tiny"
    repo.mkdir(parents=True)
    (repo / "config.json").write_bytes(open(cfg_path, "rb").read())
    (repo / "model.safetensors").symlink_to(model_path)
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path))
    tm = Zonos.from_pretrained("Zyphra/tiny", device="cpu")
    _assert_same_bf16_leaves(jm.params, tm.params)
    with pytest.raises(FileNotFoundError):
        Zonos.from_pretrained("Zyphra/missing", device="cpu")


def test_hybrid_wqkv_alias():
    """mamba_ssm names an attention layer's fused projection ``mixer.Wqkv``;
    both names give the JAX converter's matrix."""
    from zonos_tpu.models.hybrid import convert_hybrid_backbone as jax_convert

    jcfg = _tiny_hybrid_cfg()
    sd = _fake_sd_hybrid(jcfg)
    pre = f"backbone.layers.{jcfg.backbone.attn_layer_idx[0]}.mixer."
    aliased = dict(sd)
    aliased[pre + "Wqkv.weight"] = aliased.pop(pre + "in_proj.weight")
    cfg = ZonosConfig.from_dict(jax_config_dict(jcfg))
    put = _Put("cpu", torch.float32)
    ref = jax_convert(aliased, jcfg)
    for d in (sd, aliased):
        got = convert_hybrid_backbone({k: torch.from_numpy(v) for k, v in d.items()}, cfg, put)
        for path, a, b in _pairs(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=path)


def test_export_refuses_quantized_params(checkpoint, tmp_path):
    _, _, cfg_path, model_path, _, _ = checkpoint
    tm = Zonos.from_local(cfg_path, model_path, device="cpu").quantize_int8()
    with pytest.raises(ValueError, match="quantized"):
        export_zonos_checkpoint(tm.config, tm.params, str(tmp_path / "q"))


# ---------------------------------------------------------------------------
# DAC from an HF DacModel state dict
# ---------------------------------------------------------------------------

TINY_DAC = DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
                     n_codebooks=3, codebook_size=16, codebook_dim=4)


@pytest.fixture(scope="module")
def hf_dac_state_dict():
    """A tiny HF DacModel with weight norm as parametrizations (the
    layout of tests/test_dac.py)."""
    pytest.importorskip("transformers")
    from transformers.models.dac import DacConfig as HFDacConfig
    from transformers.models.dac import DacModel

    torch.manual_seed(0)
    model = DacModel(HFDacConfig(
        encoder_hidden_size=TINY_DAC.encoder_hidden_size,
        downsampling_ratios=list(TINY_DAC.downsampling_ratios),
        decoder_hidden_size=TINY_DAC.decoder_hidden_size, n_codebooks=TINY_DAC.n_codebooks,
        codebook_size=TINY_DAC.codebook_size, codebook_dim=TINY_DAC.codebook_dim,
        sampling_rate=44100)).eval()
    model.apply_weight_norm()
    g = torch.Generator().manual_seed(1)
    sd = {}
    for k, v in model.state_dict().items():  # non-unit snake alphas and norms
        v = v.detach().clone()
        if k.endswith("alpha") or k.endswith("original0"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        sd[k] = v
    assert any(k.endswith("parametrizations.weight.original1") for k in sd)
    return sd


def test_dac_from_hf_state_dict_matches_jax(hf_dac_state_dict):
    from zonos_tpu.models.dac.codec import DACConfig as JaxDACConfig
    from zonos_tpu.models.dac.codec import dac_decode as jax_dac_decode
    from zonos_tpu.models.dac.convert import convert_dac_state_dict as jax_convert

    jcfg = JaxDACConfig(**{f: getattr(TINY_DAC, f) for f in (
        "encoder_hidden_size", "downsampling_ratios", "decoder_hidden_size", "n_codebooks",
        "codebook_size", "codebook_dim")})
    codes = np.random.default_rng(2).integers(0, TINY_DAC.codebook_size, (2, 3, 10))
    ref = np.asarray(jax_dac_decode(jax_convert(hf_dac_state_dict, jcfg), jcfg,
                                    jnp.asarray(codes, jnp.int32)))  # [B, samples, 1]
    params = convert_dac_state_dict(hf_dac_state_dict, TINY_DAC)
    with torch.inference_mode():
        got = dac_decode(params, TINY_DAC, torch.from_numpy(codes)).numpy()
    assert got.shape == ref.shape == (2, 10 * TINY_DAC.hop_length, 1)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_dac_autoencoder_reads_the_models_dir(hf_dac_state_dict, tmp_path, monkeypatch):
    """``DACAutoencoder`` picks ``descript/dac_44khz/model.safetensors`` up
    from ``$ZONOS_TPU_MODELS_DIR``; a file in ``weight_g`` / ``weight_v``
    naming written by ``export_dac_state_dict`` folds back to the same
    weights (the parametrization naming: the test above)."""
    want = convert_dac_state_dict(hf_dac_state_dict, TINY_DAC)
    sd = export_dac_state_dict(want, torch.Generator().manual_seed(3))
    assert any(k.endswith(".weight_g") for k in sd)
    (tmp_path / "descript" / "dac_44khz").mkdir(parents=True)
    save_safetensors(str(tmp_path / "descript" / "dac_44khz" / "model.safetensors"), sd)
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path))
    dac = DACAutoencoder(cfg=TINY_DAC, device="cpu")
    for path, a, b in _pairs(want, dac.params):
        torch.testing.assert_close(b, a, rtol=2e-6, atol=1e-7, msg=path)
    monkeypatch.setenv("ZONOS_TPU_MODELS_DIR", str(tmp_path / "none"))
    seeded = DACAutoencoder(cfg=TINY_DAC, device="cpu", seed=5)  # warns, random init
    assert not torch.equal(seeded.params["decoder"]["conv2"]["w"],
                           dac.params["decoder"]["conv2"]["w"])
