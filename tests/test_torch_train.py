"""The port's training path (ray_tpu_torch.models.llama.loss_fn and
ray_tpu_torch.models.training) against the JAX package's, on the CPU.

Same seeded numpy inputs and the JAX parameters (params_from_jax) on both
sides, f32. JAX's loss on the CPU takes its reference attention; the
port's takes the plain versions of its flash kernels. Tolerances are
stated beside each check.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu.models import training as jtraining
from ray_tpu_torch.models import llama, training
from ray_tpu_torch.ops import attention as attn_ops


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _jax_named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def _model(tied: bool, fused: bool):
    jcfg = dataclasses.replace(jllama.LlamaConfig.debug(),
                               tie_embeddings=tied, fused_ce=fused)
    cfg = dataclasses.replace(llama.LlamaConfig.debug(),
                              tie_embeddings=tied, fused_ce=fused)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(seed, b, s, vocab, mask=False, positions=False):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if mask:
        batch["mask"] = (r.random((b, s)) > 0.3).astype(np.float32)
    if positions:
        batch["positions"] = (np.arange(s, dtype=np.int32)[None]
                              + np.array([[0], [7]], np.int32))
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# -- loss_fn and its gradients ------------------------------------------------


@pytest.mark.parametrize("tied,fused,mask,positions", [
    (False, True, False, False),
    (False, False, False, False),
    (False, True, True, False),
    (True, True, False, True),
    (True, False, True, False),
])
def test_loss_fn_value_and_grads_match_jax(tied, fused, mask, positions):
    """loss_fn's value and the gradient of every parameter leaf against
    jax.value_and_grad of the JAX loss_fn (fused CE on and off, a mask,
    explicit positions, tied embeddings, where the gather's gradient and
    the output projection's add up in one embed gradient). f32 on both
    sides, the same formulas summed in another order over 32 tokens and
    two layers: the readings differ by ~1e-6 of each leaf's largest
    gradient, so each leaf is held to 1e-5 of its own largest value."""
    jcfg, jparams, cfg, params = _model(tied, fused)
    jbatch, batch = _batch(0, 2, 16, cfg.vocab_size, mask, positions)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    leaves = _named_leaves(params)
    for _, t in leaves:
        t.requires_grad_()
    loss, metrics = llama.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss", "tokens", "perplexity"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(jmetrics[key]), rtol=1e-5)
    ref = _jax_named(jgrads)
    assert set(ref) == {name for name, _ in leaves}
    for (name, _), g in zip(leaves, grads):
        r = ref[name]
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_remat_modes_are_validated():
    """remat as JAX validates it: a bad value raises ValueError; the
    checkpointing modes run when autograd records the forward (their
    values are held against JAX in test_remat_loss_and_grads_match_jax);
    without a parameter that requires grad, or under no_grad, nothing is
    saved to checkpoint and the forward runs as it is."""
    _, _, cfg, params = _model(False, True)
    _, batch = _batch(1, 1, 8, cfg.vocab_size)
    with pytest.raises(ValueError, match="remat"):
        llama.loss_fn(params, batch, dataclasses.replace(cfg, remat="all"))
    loss, _ = llama.loss_fn(params, batch,
                            dataclasses.replace(cfg, remat="gate"))
    assert torch.isfinite(loss)
    params["final_norm"].requires_grad_()
    params["layers"]["w1"].requires_grad_()
    for mode in (True, "gate", "mlp"):
        loss, _ = llama.loss_fn(params, batch,
                                dataclasses.replace(cfg, remat=mode))
        grads = torch.autograd.grad(
            loss, [params["final_norm"], params["layers"]["w1"]])
        assert torch.isfinite(loss)
        assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0
                   for g in grads)
    with torch.no_grad():
        loss, _ = llama.loss_fn(params, batch,
                                dataclasses.replace(cfg, remat=True))
    assert torch.isfinite(loss)


_REMAT_MODES = [True, "gate", "mlp"]


@pytest.mark.parametrize("attention", ["flash", "reference"])
@pytest.mark.parametrize("remat", _REMAT_MODES, ids=str)
def test_remat_loss_and_grads_match_jax(remat, attention):
    """loss_fn's value and the gradient of every parameter leaf with each
    layer checkpointed, against the port at remat=False (the same ops in
    the same order: the recomputed values equal the first ones) and
    against jax.value_and_grad of the JAX loss_fn at the same remat mode.
    JAX on the CPU takes its reference attention, so its flash names are
    absent there: this checks values, not what is saved. The port runs
    its flash op (the kernels' plain versions) or its plain attention.
    f32 on both sides: each leaf is held to 1e-5 of its own largest
    value, as in test_loss_fn_value_and_grads_match_jax."""
    jcfg, jparams, cfg, params = _model(False, True)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg = dataclasses.replace(cfg, attention=attention)
    jbatch, batch = _batch(3, 2, 16, cfg.vocab_size, mask=True)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    leaves = _named_leaves(params)
    for _, t in leaves:
        t.requires_grad_()

    def loss_and_grads(mode):
        loss, _ = llama.loss_fn(params, batch,
                                dataclasses.replace(cfg, remat=mode))
        return loss, torch.autograd.grad(loss, [t for _, t in leaves])

    loss, grads = loss_and_grads(remat)
    loss0, grads0 = loss_and_grads(False)
    np.testing.assert_allclose(loss.item(), loss0.item(), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = _jax_named(jgrads)
    for (name, _), g, g0 in zip(leaves, grads, grads0):
        r = ref[name]
        for label, want in (("remat=False", g0.numpy()), ("JAX", r)):
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=f"{name} against {label}")


class _OpCount(TorchDispatchMode):
    """Counts the ops that run under it, by name; a matrix product whose
    second operand is one of ``weights`` (untransposed) is counted as
    ``"@" + its name``: a forward projection, not a gradient product."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if func is torch.ops.aten.mm.default and args[1].is_contiguous():
            name = self.weights.get(args[1].data_ptr(), name)
        self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", _REMAT_MODES, ids=str)
def test_remat_saves_what_the_mode_names(remat, monkeypatch):
    """What a checkpointed layer saves is what the mode names, as JAX's
    save_only_these_names: the flash forward's (o, lse) in every mode,
    ffn_gate under "gate" and "mlp", ffn_up under "mlp". Counted over
    forward and backward: the flash forward's plain version and the
    saved ops run once per layer, in the forward only; each layer's
    selective-checkpoint policy saves these ops and no other (the list
    form of create_selective_checkpoint_contexts recomputes every op not
    listed); the backward reruns the norms (rsqrt), the q,
    k, v and wo projections and the MLP products the mode does not
    save, up to the last saved value (early stop: the w2 product is not
    rerun). w1's product runs in the backward in every mode: under
    "gate" and "mlp" for silu's derivative inside ffn_gate's backward,
    as in JAX, whose named silu output leaves its input unsaved."""
    _, _, cfg, params = _model(False, True)
    cfg = dataclasses.replace(cfg, attention="flash", remat=remat)
    n = cfg.n_layers
    _, batch = _batch(4, 2, 16, cfg.vocab_size)
    leaves = [t.requires_grad_() for _, t in _named_leaves(params)]
    weights = {params["layers"][name][i].data_ptr(): "@" + name
               for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
               for i in range(n)}
    plain = collections.Counter()
    phase = ["forward"]
    fwd_reference = attn_ops.flash_attention_fwd_reference

    def counted(*args, **kwargs):
        plain[phase[0]] += 1
        return fwd_reference(*args, **kwargs)

    monkeypatch.setattr(attn_ops, "flash_attention_fwd_reference", counted)
    policies = []
    contexts = llama.create_selective_checkpoint_contexts

    def recording(ops_to_save, *args, **kwargs):
        policies.append(sorted(str(op) for op in ops_to_save))
        return contexts(ops_to_save, *args, **kwargs)

    monkeypatch.setattr(llama, "create_selective_checkpoint_contexts",
                        recording)
    fwd, bwd = _OpCount(weights), _OpCount(weights)
    with fwd:
        loss, _ = llama.loss_fn(params, batch, cfg)
    phase[0] = "backward"
    with bwd:
        torch.autograd.grad(loss, leaves)

    saved = {"ray_tpu_torch.flash_fwd.default"}
    if remat in ("gate", "mlp"):
        saved.add("ray_tpu_torch.ffn_gate.default")
    if remat == "mlp":
        saved.add("ray_tpu_torch.ffn_up.default")
    assert plain == {"forward": n}
    # One policy per layer, each saving the outputs of these ops only.
    assert policies == [sorted(saved)] * n
    for op in saved:
        assert (fwd.counts[op], bwd.counts[op]) == (n, 0), op
    rerun = {"aten.rsqrt.default": 2 * n, "@wq": n, "@wk": n, "@wv": n,
             "@wo": n, "@w1": n, "@w3": 0 if remat == "mlp" else n,
             "@w2": 0, "aten.silu.default": n if remat is True else 0}
    assert {k: bwd.counts[k] for k in rerun} == rerun


@pytest.mark.parametrize("attention,error,match", [
    ("ring", NotImplementedError, "Queue 1, item 5"),
    ("ulysses", NotImplementedError, "Queue 1, item 5"),
    ("flash2", ValueError, "attention='flash2'"),
])
def test_attention_routes_are_validated(attention, error, match):
    """cfg.attention as JAX routes it: the context-parallel routes are
    not ported and raise at the call (no quiet fall back to one-device
    attention); an unknown route raises ValueError. The other routes
    are held against JAX in test_torch_llama.py."""
    _, _, cfg, params = _model(False, True)
    _, batch = _batch(1, 1, 8, cfg.vocab_size)
    with pytest.raises(error, match=match):
        llama.loss_fn(params, batch,
                      dataclasses.replace(cfg, attention=attention))


# -- the optimizer against optax ----------------------------------------------


def _opt_params(r):
    return {"w": r.standard_normal((4, 8)).astype(np.float32),
            "b": r.standard_normal(8).astype(np.float32),
            "layers": {"m": r.standard_normal((2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("kwargs", [
    dict(warmup_steps=3),                      # linear warmup from lr 0
    dict(warmup_steps=2, total_steps=5),       # warmup + cosine to 0
    dict(warmup_steps=0),                      # constant
    dict(warmup_steps=0, total_steps=4),       # cosine, no warmup
    dict(warmup_steps=0, grad_clip=1e9),       # clipping never triggers
    dict(warmup_steps=1, moment_dtype="bfloat16"),
    dict(warmup_steps=0, moment_dtype="bfloat16", param_dtype="bfloat16"),
], ids=["warmup", "warmup_cosine", "constant", "cosine", "no_clip",
        "bf16_mu", "bf16_params"])
def test_make_optimizer_matches_optax(kwargs):
    """Six updates of make_optimizer against the JAX make_optimizer
    (optax) on the same gradients: parameters, both moments and the
    count after every step. The gradients are scaled so the global norm
    crosses the clipping limit of 1 both ways. f32: the same formulas;
    the bias corrections and the norm are rounded in another order, a
    few ulps of each value (rtol 1e-5, atol 1e-6 for values near 0). A
    bf16 first moment is stored rounded on both sides; it may round the
    other way from f32 inputs that differ in the last ulp (one bf16 ulp,
    at most 2**-7 relative). With bf16 parameters (the card's training dtype)
    every value is bf16 and held to one bf16 ulp, apart from the global
    norm, which the port accumulates in f32 and optax rounds to bf16."""
    lr = 1e-2
    jkw = dict(kwargs)
    tkw = dict(kwargs)
    pdt = jkw.pop("param_dtype", "float32")
    tkw.pop("param_dtype", None)
    if "moment_dtype" in kwargs:
        jkw["moment_dtype"] = getattr(jnp, kwargs["moment_dtype"])
        tkw["moment_dtype"] = getattr(torch, kwargs["moment_dtype"])
    jtx = jtraining.make_optimizer(lr, **jkw)
    tx = training.make_optimizer(lr, **tkw)
    r = np.random.default_rng(14)
    p0 = _opt_params(r)
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(getattr(jnp, pdt)), p0)
    params = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(x).to(getattr(torch, pdt)), p0)
    jstate = jtx.init(jparams)
    state = tx.init(params)
    for i in range(6):
        g = jax.tree_util.tree_map(
            lambda x: (r.standard_normal(x.shape) * (0.05, 1.0)[i % 2])
            .astype(np.float32), p0)
        updates, jstate = jtx.update(jax.tree_util.tree_map(
            lambda x: jnp.asarray(x).astype(getattr(jnp, pdt)), g),
            jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = tx.update(jax.tree_util.tree_map(
            lambda x: torch.from_numpy(x).to(getattr(torch, pdt)), g),
            state, params)
        adam = jstate[1]
        assert state["count"] == int(adam.count) == i + 1
        tol = dict(rtol=1e-5, atol=1e-6) if pdt == "float32" else \
            dict(rtol=2 ** -7, atol=1e-6)
        for name, ref in _jax_named(jparams).items():
            got = dict(_named_leaves(params))[name]
            np.testing.assert_allclose(got.float().numpy(),
                                       ref.astype(np.float32), **tol,
                                       err_msg=f"step {i} {name}")
        mu_tol = tol if "moment_dtype" not in kwargs else \
            dict(rtol=2 ** -7, atol=1e-6)
        for key, ref_tree, t in (("mu", adam.mu, mu_tol),
                                 ("nu", adam.nu, tol)):
            got = dict(_named_leaves(state[key]))
            for name, ref in _jax_named(ref_tree).items():
                assert got[name].dtype == getattr(
                    torch, str(np.asarray(ref).dtype))
                np.testing.assert_allclose(
                    got[name].float().numpy(), ref.astype(np.float32), **t,
                    err_msg=f"step {i} {key}{name}")


def test_warmup_starts_at_zero_and_cosine_ends_at_zero():
    tx = training.make_optimizer(1.0, warmup_steps=4, total_steps=10)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1.0, 4, 10)
    got = [tx.schedule(c) for c in range(12)]
    np.testing.assert_allclose(got, [float(ref(c)) for c in range(12)],
                               rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and got[-1] == 0.0


# -- three train steps against JAX -------------------------------------------


def test_three_train_steps_match_jax():
    """make_train_step against the JAX make_train_step (jit, no mesh) for
    three steps on one batch: loss and grad_norm (taken before clipping)
    to 1e-5, every parameter after every step to an absolute tolerance
    of lr/100. Adam normalises each update to about lr, so where |g| is
    near eps an f32-level difference in the gradient moves the update by
    a fraction of lr; the readings reach 1.6e-3 lr after three steps."""
    lr = 1e-2
    jcfg, jparams, cfg, params = _model(False, True)
    jbatch, batch = _batch(2, 4, 32, cfg.vocab_size)
    jtx = jtraining.make_optimizer(lr, warmup_steps=0)
    tx = training.make_optimizer(lr, warmup_steps=0)
    jstate = jtraining.init_train_state(jparams, jtx)
    state = training.init_train_state(params, tx)
    jstep = jtraining.make_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), jtx, donate=False)
    step = training.make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), tx)
    eval_step = training.make_eval_step(
        lambda p, b: llama.loss_fn(p, b, cfg))
    losses = []
    for i in range(3):
        jstate, jmetrics = jstep(jstate, jbatch)
        before = state.params["layers"]["wq"]
        state, metrics = step(state, batch)
        assert state.step == i + 1 and state.params["layers"]["wq"] is before
        for key in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(metrics[key].item(),
                                       float(jmetrics[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        ref = _jax_named(jstate.params)
        for name, t in _named_leaves(state.params):
            assert not t.requires_grad
            np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-5,
                                       atol=lr / 100,
                                       err_msg=f"step {i} {name}")
        losses.append(metrics["loss"].item())
    assert losses[2] < losses[0]
    after = eval_step(state.params, batch)
    assert after["loss"].item() < losses[2]
