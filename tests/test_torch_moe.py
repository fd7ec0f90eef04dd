"""The port's MoE model (ray_tpu_torch.models.moe) against the JAX
package's (ray_tpu.models.moe), on the CPU.

MoEConfig.debug_moe() (f32) with the JAX parameters carried over
(moe_params_from_jax) and the same seeded numpy tokens on both sides.
JAX's attention="auto" takes its reference attention on the CPU; the
port's "auto" takes its plain attention there, and "flash" the plain
versions of its flash kernels. Tolerances are stated beside each check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtraining
from ray_tpu.parallel.sharding import DEFAULT_RULES
from ray_tpu_torch.models import moe, training


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _jax_named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def _model(seed=0, **overrides):
    jcfg = dataclasses.replace(jmoe.MoEConfig.debug_moe(), **overrides)
    cfg = dataclasses.replace(moe.MoEConfig.debug_moe(), **overrides)
    jparams = jmoe.init_moe_params(jcfg, jax.random.PRNGKey(seed))
    params = moe.moe_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(seed, b, s, vocab, positions=False):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if positions:
        batch["positions"] = (np.arange(s, dtype=np.int32)[None]
                              + np.arange(b, dtype=np.int32)[:, None] * 5)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_configs_match_jax():
    """Same fields and defaults, presets included (dtype aside: a torch
    dtype against a jnp one)."""
    for name in ("debug_moe", "mixtral_8x7b"):
        j = dataclasses.asdict(getattr(jmoe.MoEConfig, name)())
        t = dataclasses.asdict(getattr(moe.MoEConfig, name)())
        assert str(j.pop("dtype").__name__) == str(t.pop("dtype")).split(
            ".")[-1]
        assert j == t, name


def test_param_shapes_match_jax():
    jcfg, jparams, cfg, params = _model()
    ref = {k: v.shape for k, v in _jax_named(jparams).items()}
    got = {k: tuple(v.shape) for k, v in _named_leaves(params)}
    assert got == ref
    fresh = moe.init_moe_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert {k: tuple(v.shape) for k, v in _named_leaves(fresh)} == ref
    with pytest.raises(KeyError, match="moe_params_from_jax"):
        bad = jax.tree_util.tree_map(np.asarray, jparams)
        del bad["layers"]["router"]
        moe.moe_params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("attention,positions", [
    ("auto", False), ("flash", False), ("auto", True)])
def test_moe_forward_matches_jax(attention, positions):
    """Logits and aux loss of moe_forward. f32 on both sides, the same
    formulas summed in another order over 2 layers: the readings differ
    by ~2e-7 of logits of size ~0.1-1, so they are held to 1e-5
    absolute; the aux loss to 1e-6 relative."""
    jcfg, jparams, cfg, params = _model()
    cfg = dataclasses.replace(cfg, attention=attention)
    jbatch, batch = _batch(1, 2, 16, cfg.vocab_size, positions)
    jlogits, jaux = jmoe.moe_forward(jparams, jbatch["tokens"], jcfg,
                                     positions=jbatch.get("positions"))
    logits, aux = moe.moe_forward(params, batch["tokens"].long(), cfg,
                                  positions=batch.get("positions"))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    # Balanced-ish routing at init, as tests/models/test_moe.py expects.
    assert 0.9 < aux.item() < 3.0


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    """moe_loss_fn's loss, its metrics and the gradient of every leaf
    against jax.value_and_grad of the JAX moe_loss_fn (with JAX's
    remat, nothing_saveable, where the port checkpoints). f32: each leaf
    held to 1e-5 of its own largest gradient, the loss to 1e-5."""
    jcfg, jparams, cfg, params = _model(remat=remat)
    jbatch, batch = _batch(2, 2, 16, cfg.vocab_size)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jmoe.moe_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    leaves = _named_leaves(params)
    for _, t in leaves:
        t.requires_grad_()
    loss, metrics = moe.moe_loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss", "ce_loss", "aux_loss"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    ref = _jax_named(jgrads)
    assert set(ref) == {name for name, _ in leaves}
    for (name, _), g in zip(leaves, grads):
        r = ref[name]
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_remat_gives_the_same_gradients():
    """remat=True reruns each layer in the backward: the same f32 ops on
    the same inputs, so every gradient equals remat=False's to 1e-6 of
    the leaf's largest value."""
    _, _, cfg, params = _model()
    _, batch = _batch(3, 2, 16, cfg.vocab_size)
    leaves = [t for _, t in _named_leaves(params)]
    for t in leaves:
        t.requires_grad_()
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _ = moe.moe_loss_fn(params, batch, c)
        out[remat] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * b.abs().max().item())


# -- gating ---------------------------------------------------------------------


def _ffn_inputs(router):
    """One layer's weights of debug_moe with the given router ``[D, E]``,
    and exact inputs ``x [1, 6, D]`` (multiples of 1/2 in [-1, 1]); both
    sides get the same values."""
    cfg = moe.MoEConfig.debug_moe()
    r = np.random.default_rng(7)
    d, e, h = cfg.dim, cfg.n_experts, cfg.hidden_dim
    lp = {"router": router.astype(np.float32),
          "we1": (r.standard_normal((e, d, h)) * 0.1).astype(np.float32),
          "we3": (r.standard_normal((e, d, h)) * 0.1).astype(np.float32),
          "we2": (r.standard_normal((e, h, d)) * 0.1).astype(np.float32)}
    x = (r.integers(-2, 3, (1, 6, d)) / 2).astype(np.float32)
    return cfg, lp, x


def _both_ffn(cfg, lp, x):
    jcfg = jmoe.MoEConfig.debug_moe()
    jout, jaux = jmoe._moe_ffn(jcfg, {k: jnp.asarray(v) for k, v in
                                      lp.items()}, jnp.asarray(x), None,
                               DEFAULT_RULES)
    out, aux = moe._moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in
                                  lp.items()}, torch.from_numpy(x))
    return np.asarray(jout), float(jaux), out.numpy(), aux.item()


def _dense_reference(lp, x, gates):
    """The FFN with the given gates ``[B, S, E]``, in float64."""
    x, g = x.astype(np.float64), gates.astype(np.float64)
    a = np.einsum("bsd,edf->ebsf", x, lp["we1"])
    u = np.einsum("bsd,edf->ebsf", x, lp["we3"])
    hidden = a / (1 + np.exp(-a)) * u
    per = np.einsum("ebsf,efd->ebsd", hidden, lp["we2"])
    return np.einsum("ebsd,bse->bsd", per, g)


def _probs(lp, x):
    logits = np.einsum("bsd,de->bse", x.astype(np.float64), lp["router"])
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def test_gating_selects_exactly_k_experts():
    """A random router (no ties): each token's output is the dense FFN
    with exactly the top-2 experts' renormalised probabilities as gates,
    on both sides (f64 reference, 1e-5 absolute), and the aux loss is
    E * sum_e (share of tokens sent to e) * (mean prob of e)."""
    r = np.random.default_rng(3)
    cfg, lp, x = _ffn_inputs(r.standard_normal((64, 4)) * 0.3)
    p = _probs(lp, x)
    top = np.argsort(-p, axis=-1)[..., :2]
    mask = np.zeros_like(p)
    np.put_along_axis(mask, top, 1.0, axis=-1)
    gates = p * mask / (p * mask).sum(-1, keepdims=True)
    want = _dense_reference(lp, x, gates)
    want_aux = 4 * (mask.mean((0, 1)) * p.mean((0, 1))).sum()
    jout, jaux, out, aux = _both_ffn(cfg, lp, x)
    for got, got_aux in ((jout, jaux), (out, aux)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_aux, want_aux, rtol=1e-5)


@pytest.mark.parametrize("tie", ["three-way at the 2nd", "all four"])
def test_gating_tie_selects_more_than_k(tie):
    """A planted tie at the k-th largest probability selects every tied
    expert, on both sides: experts 1 and 2 have identical router columns
    (exact products: multiples of 1/8 times multiples of 1/2) and expert
    0 a larger one, so three experts are selected; with a zero router all
    four tie, each gate is 1/4 and the aux loss reads E = 4 (top-k by
    index would give 2)."""
    router = np.zeros((64, 4), np.float32)
    if tie == "three-way at the 2nd":
        router[:, 0] = 0.25
        router[:, 1] = router[:, 2] = 0.125
        router[:, 3] = -0.5
    cfg, lp, x = _ffn_inputs(router)
    x = np.abs(x)  # so expert 0 stays on top and 3 at the bottom
    p = _probs(lp, x)
    n_sel = 3 if tie == "three-way at the 2nd" else 4
    mask = np.zeros_like(p)
    mask[..., :n_sel] = 1.0
    gates = p * mask / (p * mask).sum(-1, keepdims=True)
    want = _dense_reference(lp, x, gates)
    want_aux = 4 * (mask.mean((0, 1)) * p.mean((0, 1))).sum()
    jout, jaux, out, aux = _both_ffn(cfg, lp, x)
    for got, got_aux in ((jout, jaux), (out, aux)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_aux, want_aux, rtol=1e-5)
    if tie == "all four":
        assert aux == pytest.approx(4.0, rel=1e-6)


# -- training -------------------------------------------------------------------


def test_adamw_steps_match_optax():
    """make_train_step on moe_loss_fn against the JAX make_train_step
    (optax AdamW, jit, no mesh) on one batch. Step 1: loss, ce_loss,
    aux_loss and grad_norm to 1e-5 relative, every parameter after it to
    lr/100 absolute (from equal parameters Adam's first update is about
    lr * sign(g), so an f32-level difference in g moves it by a fraction
    of lr only where |g| is near eps). Steps 2 and 3: the metrics to
    1e-4 relative (the parameters differ by f32 noise after step 1, and
    a near-zero gradient of a rarely routed expert's weight can then
    turn its next Adam update by up to ~lr), and ce_loss falls."""
    lr = 1e-2
    jcfg, jparams, cfg, params = _model()
    jbatch, batch = _batch(4, 2, 16, cfg.vocab_size)
    jtx = jtraining.make_optimizer(lr, warmup_steps=0)
    tx = training.make_optimizer(lr, warmup_steps=0)
    jstate = jtraining.init_train_state(jparams, jtx)
    state = training.init_train_state(params, tx)
    jstep = jtraining.make_train_step(
        lambda p, b: jmoe.moe_loss_fn(p, b, jcfg), jtx, donate=False)
    step = training.make_train_step(
        lambda p, b: moe.moe_loss_fn(p, b, cfg), tx)
    ce = []
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        rtol = 1e-5 if i == 0 else 1e-4
        for key in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=rtol, err_msg=f"step {i} {key}")
        if i == 0:
            ref = _jax_named(jstate.params)
            for name, t in _named_leaves(state.params):
                np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-5,
                                           atol=lr / 100, err_msg=name)
        ce.append(m["ce_loss"].item())
    assert ce[-1] < ce[0]


@pytest.mark.parametrize("remat", [False, True])
def test_launch_counts_of_a_train_step(remat, monkeypatch):
    """What chip_smoke.py's moe phase expects each train step to launch,
    counted here as calls of the kernels' entry points (their plain
    versions on the CPU), attention="flash": each layer's flash forward
    and both its norms once in the forward, and again in the backward's
    recompute under remat (nothing is saved across the checkpoint, so
    the whole layer reruns); one backward per layer; the final norm once.
    """
    from ray_tpu_torch.ops import attention as attn_ops

    calls = {"rms_norm": 0, "flash_fwd": 0, "flash_bwd": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(moe, "rms_norm", counting("rms_norm", moe.rms_norm))
    monkeypatch.setattr(attn_ops, "_flash_fwd",
                        counting("flash_fwd", attn_ops._flash_fwd))
    monkeypatch.setattr(attn_ops, "flash_attention_bwd",
                        counting("flash_bwd", attn_ops.flash_attention_bwd))
    _, _, cfg, params = _model(remat=remat)
    cfg = dataclasses.replace(cfg, attention="flash")
    _, batch = _batch(5, 2, 16, cfg.vocab_size)
    tx = training.make_optimizer(1e-3, warmup_steps=0)
    step = training.make_train_step(
        lambda p, b: moe.moe_loss_fn(p, b, cfg), tx)
    _, m = step(training.init_train_state(params, tx), batch)
    n = cfg.n_layers
    reruns = 2 if remat else 1
    assert calls == {"rms_norm": 2 * n * reruns + 1,
                     "flash_fwd": n * reruns, "flash_bwd": n}
    assert np.isfinite(m["loss"].item())
