"""The port's Llama (ray_tpu_torch.models.llama) against the JAX package's
on LlamaConfig.debug(), on the CPU, with the JAX parameters carried over
by params_from_jax.

Tolerance: atol/rtol 2e-4 on f32 logits, as tests/serve/test_llm.py uses
between the JAX cached and full forwards — the same math in f32, summed
in a different order over two layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.debug()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = llama.LlamaConfig.debug()
    params = llama.params_from_jax(np_params, cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("attention", ["reference", "flash", "auto"])
def test_forward_matches_jax(model, attention):
    """Each attention route of the port's forward_hidden ("auto" is the
    plain attention on the CPU, "flash" the flash kernels' plain version)
    against JAX's forward on its reference attention."""
    jcfg, jparams, cfg, params = model
    jcfg = dataclasses.replace(jcfg, attention="reference")
    cfg = dataclasses.replace(cfg, attention=attention)
    toks = _tokens(0, (2, 16), cfg.vocab_size)
    ref = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = llama.forward(params, torch.from_numpy(toks), cfg).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_forward_with_positions_matches_jax(model):
    jcfg, jparams, cfg, params = model
    toks = _tokens(1, (1, 8), cfg.vocab_size)
    pos = (np.arange(8, dtype=np.int32) + 5)[None]
    ref = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg,
                                    positions=jnp.asarray(pos)))
    got = llama.forward(params, torch.from_numpy(toks), cfg,
                        positions=torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_forward_with_cache_prefill_then_decode_matches_jax(model):
    """Prefill 8 tokens at ragged starts, then 4 decode steps: logits at
    every step and the whole KV cache agree with JAX."""
    jcfg, jparams, cfg, params = model
    toks = _tokens(2, (2, 12), cfg.vocab_size)
    start = np.array([0, 3], np.int32)
    jcache = jllama.init_kv_cache(jcfg, 2, 32)
    cache = llama.init_kv_cache(cfg, 2, 32, device="cpu")

    jl, jcache = jllama.forward_with_cache(
        jparams, jnp.asarray(toks[:, :8]), jcfg, jcache, jnp.asarray(start))
    got, cache = llama.forward_with_cache(
        params, torch.from_numpy(toks[:, :8]), cfg, cache,
        torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    for i in range(8, 12):
        pos = start + i
        jl, jcache = jllama.forward_with_cache(
            jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jcache,
            jnp.asarray(pos))
        got, cache = llama.forward_with_cache(
            params, torch.from_numpy(toks[:, i:i + 1]), cfg, cache,
            torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_cache_write_clamps_like_dynamic_update_slice(model):
    """A write that would run past the slot's end starts at S - T instead
    (lax.dynamic_update_slice's clamp); RoPE and the mask keep the
    unclamped positions. Same cache and logits as JAX."""
    jcfg, jparams, cfg, params = model
    toks = _tokens(3, (1, 8), cfg.vocab_size)
    start = np.array([12], np.int32)  # 12 + 8 > S = 16 → written at 8..15
    jl, jcache = jllama.forward_with_cache(
        jparams, jnp.asarray(toks), jcfg, jllama.init_kv_cache(jcfg, 1, 16),
        jnp.asarray(start))
    cache = llama.init_kv_cache(cfg, 1, 16, device="cpu")
    got, cache = llama.forward_with_cache(
        params, torch.from_numpy(toks), cfg, cache, torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    written = cache["k"][0, 0].abs().sum(dim=(-1, -2))
    assert (written[:8] == 0).all() and (written[8:] > 0).all()


def test_params_from_jax_checks_keys_and_shapes(model):
    jcfg, jparams, cfg, _ = model
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    bad = dict(np_params, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        llama.params_from_jax(bad, cfg, device="cpu")
    missing = {k: v for k, v in np_params.items() if k != "embed"}
    with pytest.raises(KeyError, match="embed"):
        llama.params_from_jax(missing, cfg, device="cpu")


def test_params_from_jax_bf16_bits_exact():
    """bf16 JAX arrays carry over bit for bit (ml_dtypes → torch)."""
    jcfg = jllama.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                              n_kv_heads=1, hidden_dim=64, max_seq_len=16,
                              tie_embeddings=True)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = llama.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                            n_kv_heads=1, hidden_dim=64, max_seq_len=16,
                            tie_embeddings=True)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    assert "out" not in params and params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers"]["wq"].float().numpy(),
        np.asarray(jparams["layers"]["wq"].astype(jnp.float32)))


def test_init_params_shapes_and_seed():
    cfg = llama.LlamaConfig.debug()
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    shapes = llama.param_shapes(cfg)
    assert tuple(a["embed"].shape) == shapes["embed"]
    for name, shape in shapes["layers"].items():
        assert tuple(a["layers"][name].shape) == shape
        assert torch.equal(a["layers"][name], b["layers"][name])
    n = sum(t.numel() for t in [a["embed"], a["final_norm"], a["out"]]
            + list(a["layers"].values()))
    assert n == cfg.num_params()
