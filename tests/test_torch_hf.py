"""The port's HF checkpoint interop (ray_tpu_torch.models.hf) against the
JAX package's (ray_tpu.models.hf) and against transformers, on the CPU.

No weights are downloaded: every checkpoint here is written by the test
from a seed, in the HF layout (transformers' own LlamaForCausalLM where
transformers is installed, safetensors' own writer where it is, and the
writer of chip_smoke.py, which the card's run uses).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import hf as jhf
from ray_tpu_torch.models import hf, llama

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(tied: bool) -> dict:
    """A tiny Llama's config.json (GQA, 2 layers, head_dim 16)."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "max_position_embeddings": 64,
            "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "tie_word_embeddings": tied}


def _state_dict(cfg: dict, seed: int) -> dict:
    """Random f32 tensors under the HF Llama names and shapes."""
    r = np.random.default_rng(seed)
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd

    def t(*shape):
        return torch.from_numpy(
            (r.standard_normal(shape) * 0.05).astype(np.float32))

    sd = {"model.embed_tokens.weight": t(cfg["vocab_size"], d),
          "model.norm.weight": 1 + t(d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({
            p + "self_attn.q_proj.weight": t(d, d),
            p + "self_attn.k_proj.weight": t(kv, d),
            p + "self_attn.v_proj.weight": t(kv, d),
            p + "self_attn.o_proj.weight": t(d, d),
            p + "mlp.gate_proj.weight": t(f, d),
            p + "mlp.up_proj.weight": t(f, d),
            p + "mlp.down_proj.weight": t(d, f),
            p + "input_layernorm.weight": 1 + t(d),
            p + "post_attention_layernorm.weight": 1 + t(d)})
    if not cfg["tie_word_embeddings"]:
        sd["lm_head.weight"] = t(cfg["vocab_size"], d)
    return sd


def _jax_named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k, t in tree.items()
                for n, v in _named(t, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _assert_bit_equal(params, ref):
    got = _named(params)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert tuple(g.shape) == r.shape, name
        assert torch.equal(g, torch.from_numpy(np.array(r))), name


@pytest.mark.parametrize("tied", [False, True])
def test_config_from_hf_dict_matches_jax(tied):
    """Every field the JAX package maps, from a config.json dict (dtype
    and the port-only defaults aside)."""
    jcfg = jhf.config_from_hf(type("C", (), _config(tied))())
    cfg = hf.config_from_hf(_config(tied))
    j = dataclasses.asdict(jcfg)
    t = dataclasses.asdict(cfg)
    for k in ("dtype",):
        j.pop(k), t.pop(k)
    assert j == t
    assert cfg.tie_embeddings is tied and cfg.head_dim == 16
    no_kv = {k: v for k, v in _config(tied).items()
             if k != "num_key_value_heads"}
    assert hf.config_from_hf(no_kv).n_kv_heads == 4
    with pytest.raises(KeyError, match="hidden_size"):
        hf.config_from_hf({k: v for k, v in no_kv.items()
                           if k != "hidden_size"})


def test_config_from_hf_object_matches_jax():
    transformers = pytest.importorskip("transformers")
    obj = transformers.LlamaConfig(**{k: v for k, v in _config(False).items()
                                      if k not in ("architectures",
                                                   "model_type")})
    j = dataclasses.asdict(jhf.config_from_hf(obj))
    t = dataclasses.asdict(hf.config_from_hf(obj))
    j.pop("dtype"), t.pop("dtype")
    assert j == t


def _hf_permute(w, n_heads):
    """transformers' conversion-script ``permute`` of Q/K rows, ``[H*hd,
    D]``: the inverse of the JAX package's ``_unpermute_rope``."""
    hd = w.shape[0] // n_heads
    return w.reshape(n_heads, hd // 2, 2, -1).transpose(1, 2).reshape(
        w.shape)


def _jax_input(sd, cfg_json):
    """``sd`` with the JAX package's RoPE permutation undone ahead of it,
    so that its conversion takes the rows as they are, as the port does
    (the one deliberate difference; see ray_tpu_torch/models/hf.py)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("q_proj.weight"):
            v = _hf_permute(v, cfg_json["num_attention_heads"])
        elif k.endswith("k_proj.weight"):
            v = _hf_permute(v, cfg_json["num_key_value_heads"])
        out[k] = v.float()
    return out


def _reference_params(cfg_json, sd):
    jcfg = jhf.config_from_hf(type("C", (), cfg_json)())
    return _jax_named(jhf.params_from_hf_state_dict(
        _jax_input(sd, cfg_json), jcfg, dtype=jnp.float32))


@pytest.mark.parametrize("tied", [False, True])
def test_params_from_hf_state_dict_bit_for_bit(tied):
    """The port's parameters equal the JAX package's to the bit, f32, for
    a state dict whose Q/K rows the JAX conversion gets with its RoPE
    permutation undone (the port takes HF's rows as they are): the same
    transposes of the same values."""
    cfg_json = _config(tied)
    sd = _state_dict(cfg_json, seed=1)
    cfg = hf.config_from_hf(cfg_json)
    params = hf.params_from_hf_state_dict(sd, cfg, dtype=torch.float32,
                                          device="cpu")
    ref = _reference_params(cfg_json, sd)
    _assert_bit_equal(params, ref)
    assert ("out" in params) is not tied
    # Numpy leaves too, and the result owns its memory.
    np_sd = {k: v.numpy() for k, v in sd.items()}
    again = hf.params_from_hf_state_dict(np_sd, cfg, dtype=torch.float32,
                                         device="cpu")
    _assert_bit_equal(again, ref)
    again["embed"].zero_()
    assert sd["model.embed_tokens.weight"].abs().sum() > 0


@pytest.fixture(scope="module")
def tiny_hf_model():
    """A tiny transformers Llama whose attention projections are scaled by
    10, so that attention (and so RoPE's order) moves the logits: at
    transformers' own initialisation it hardly does."""
    transformers = pytest.importorskip("transformers")
    cfg = {k: v for k, v in _config(False).items()
           if k not in ("architectures", "model_type")}
    hf_cfg = transformers.LlamaConfig(**cfg, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    with torch.no_grad():
        for name, w in model.named_parameters():
            if ".self_attn." in name:
                w.mul_(10.0)
    model.eval()
    return model


def test_logits_match_transformers(tiny_hf_model):
    """The converted model's logits against transformers' own forward,
    f32 on the CPU, through the plain forward and the cached (serving)
    path: the same formulas, which read equal here; held to 1e-5
    absolute (logits within +-0.6). The JAX package's conversion, which
    permutes Q/K, is 0.4 off on this model (held above 0.1 here, so that
    a change of either convention shows)."""
    model = tiny_hf_model
    cfg = dataclasses.replace(hf.config_from_hf(model.config),
                              dtype=torch.float32, remat=False)
    params = hf.params_from_hf_state_dict(model.state_dict(), cfg,
                                          device="cpu")
    tokens = torch.tensor([[1, 5, 9, 33, 77, 2, 4, 8]])
    with torch.no_grad():
        want = model(tokens).logits
        got = llama.forward(params, tokens, cfg)
        cache = llama.init_kv_cache(cfg, 1, 16, device="cpu")
        cached, _ = llama.forward_with_cache(
            params, tokens, cfg, cache, torch.zeros(1, dtype=torch.int32))
    for out in (got, cached):
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
    jcfg = dataclasses.replace(jhf.config_from_hf(model.config),
                               dtype=jnp.float32, remat=False)
    jparams = jhf.params_from_hf_state_dict(model.state_dict(), jcfg,
                                            dtype=jnp.float32)
    from ray_tpu.models.llama import forward as jforward
    jlogits = np.asarray(jforward(jparams, jnp.asarray(tokens.numpy()),
                                  jcfg))
    assert np.abs(jlogits - want.numpy()).max() > 0.1


def test_load_from_save_pretrained_matches_transformers(tiny_hf_model,
                                                        tmp_path):
    """A directory that transformers itself writes (config.json and
    model.safetensors) loads and gives transformers' logits (1e-5)."""
    tiny_hf_model.save_pretrained(tmp_path, safe_serialization=True)
    cfg, params = hf.load_llama_from_hf(tmp_path, dtype=torch.float32,
                                        device="cpu")
    cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    tokens = torch.tensor([[3, 17, 42, 8, 100]])
    with torch.no_grad():
        want = tiny_hf_model(tokens).logits
        got = llama.forward(params, tokens, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_load_single_file_written_by_safetensors(tmp_path, dtype):
    """model.safetensors from safetensors.torch.save_file, in each of the
    three float types a checkpoint holds: the port's reader gives the
    stored values, and the parameters equal the JAX package's
    conversion of them, bit for bit (loaded as f32)."""
    st = pytest.importorskip("safetensors.torch")
    cfg_json = _config(False)
    sd = {k: v.to(dtype) for k, v in _state_dict(cfg_json, 3).items()}
    st.save_file(sd, str(tmp_path / "model.safetensors"),
                 metadata={"format": "pt"})
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    read = hf.read_safetensors(tmp_path / "model.safetensors")
    assert set(read) == set(sd)
    for k, v in sd.items():
        assert read[k].dtype == dtype and torch.equal(read[k], v), k
    cfg, params = hf.load_llama_from_hf(tmp_path, dtype=torch.float32,
                                        device="cpu")
    assert cfg == hf.config_from_hf(cfg_json)
    _assert_bit_equal(params, _reference_params(cfg_json, sd))
    _, native = hf.load_llama_from_hf(str(tmp_path), device="cpu")
    assert native["embed"].dtype == torch.bfloat16  # cfg.dtype


def test_load_two_shards_from_index(tmp_path):
    """Two shards and model.safetensors.index.json (HF's sharded layout),
    tied embeddings: the same parameters as one file."""
    st = pytest.importorskip("safetensors.torch")
    cfg_json = _config(True)
    sd = _state_dict(cfg_json, 4)
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for fname, keys in shards.items():
        st.save_file({k: sd[k] for k in keys}, str(tmp_path / fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0},
         "weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    cfg, params = hf.load_llama_from_hf(tmp_path, dtype=torch.float32,
                                        device="cpu")
    assert cfg.tie_embeddings and "out" not in params
    _assert_bit_equal(params, _reference_params(cfg_json, sd))


def test_chip_smoke_writer_is_read_by_safetensors_and_the_port(tmp_path):
    """The safetensors writer that chip_smoke.py uses on the card: what it
    writes reads back bit for bit through safetensors' own reader and
    through the port's, in bf16, f16 and f32, with an odd-sized tensor
    ahead of the others."""
    smoke = _chip_smoke()
    r = np.random.default_rng(5)
    tensors = {"a.odd": torch.from_numpy(r.standard_normal(3).astype(
        np.float32)).to(torch.bfloat16),
        "b.f32": torch.from_numpy(r.standard_normal((5, 7)).astype(
            np.float32)),
        "c.f16": torch.from_numpy(r.standard_normal((4, 2)).astype(
            np.float32)).half(),
        "d.bf16": torch.from_numpy(r.standard_normal((2, 3, 8)).astype(
            np.float32)).to(torch.bfloat16)}
    path = tmp_path / "x.safetensors"
    smoke.write_safetensors(path, tensors)
    for name, got in hf.read_safetensors(path).items():
        assert got.dtype == tensors[name].dtype
        assert torch.equal(got, tensors[name]), name
    st = pytest.importorskip("safetensors.torch")
    for name, got in st.load_file(str(path)).items():
        assert torch.equal(got, tensors[name]), name


def test_chip_smoke_hf_state_dict_round_trips():
    """chip_smoke.py's params → HF state dict (Q/K rows permuted to HF's
    order, no lm_head when tied), converted back by the port, gives the
    parameters again bit for bit."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(llama.LlamaConfig.debug(), tie_embeddings=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    sd = smoke.hf_state_dict(params, cfg)
    assert "lm_head.weight" not in sd
    back = hf.params_from_hf_state_dict(sd, cfg, device="cpu")
    want = _named(params)
    for name, t in _named(back).items():
        assert torch.equal(t, want[name]), name


def test_load_refuses_anything_but_a_local_directory(tmp_path):
    """A file, a missing path or a hub name raises FileNotFoundError:
    nothing is resolved or downloaded. A directory without weights
    raises too."""
    f = tmp_path / "config.json"
    f.write_text(json.dumps(_config(False)))
    for path in (f, tmp_path / "missing", "meta-llama/Llama-3.2-1B"):
        with pytest.raises(FileNotFoundError, match="not a local directory"):
            hf.load_llama_from_hf(path, device="cpu")
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf.load_llama_from_hf(tmp_path, device="cpu")


def test_reader_refuses_a_header_that_lies(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\0" * 8)
    with pytest.raises(ValueError, match="do not hold"):
        hf.read_safetensors(path)
    path.write_bytes((1 << 40).to_bytes(8, "little"))
    with pytest.raises(ValueError, match="past the end"):
        hf.read_safetensors(path)
