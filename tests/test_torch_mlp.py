"""The port's MLP baseline (ray_tpu_torch.models.mlp) against the JAX
package's (ray_tpu.models.mlp), on the CPU.

MLPConfig() (784-128-128-10, f32) with the JAX parameters carried over
(mlp_params_from_jax) and the same seeded numpy batch on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu.models import training as jtraining
from ray_tpu_torch.models import mlp, training


def _model(seed=0, **kw):
    jcfg = jmlp.MLPConfig(**kw)
    cfg = mlp.MLPConfig(**kw)
    jparams = jmlp.mlp_init(jcfg, jax.random.PRNGKey(seed))
    params = mlp.mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(seed, n, cfg):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, cfg.in_dim)).astype(np.float32)
    y = r.integers(0, cfg.n_classes, n).astype(np.int32)
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


def test_init_shapes_and_scale_match_jax():
    """The port's own draw: the JAX shapes, zero biases and weights of
    standard deviation d_in**-0.5 (within 5% over >= 1280 draws)."""
    jcfg, jparams, cfg, _ = _model()
    params = mlp.mlp_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(params) == len(jparams) == 3
    for p, jp in zip(params, jparams):
        assert tuple(p["w"].shape) == jp["w"].shape
        assert tuple(p["b"].shape) == jp["b"].shape
        assert not p["b"].any()
        want = p["w"].shape[0] ** -0.5
        assert abs(p["w"].std().item() / want - 1) < 0.05
    with pytest.raises(ValueError, match="layer 1 w"):
        bad = jax.tree_util.tree_map(np.asarray, jparams)
        bad[1]["w"] = bad[1]["w"][:, :5]
        mlp.mlp_params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("hidden", [(128, 128), (64,), ()], ids=str)
def test_forward_loss_accuracy_and_grads_match_jax(hidden):
    """mlp_forward's logits, mlp_loss's loss and accuracy, and the
    gradient of every weight and bias against jax.value_and_grad of the
    JAX mlp_loss. f32: the same formulas summed in another order over at
    most 784 terms, held to 1e-5 relative (logits and gradients to 1e-5
    of their largest value); accuracy is a count and must be equal."""
    jcfg, jparams, cfg, params = _model(hidden=hidden)
    jbatch, batch = _batch(1, 64, cfg)
    np.testing.assert_allclose(
        mlp.mlp_forward(params, batch["x"]).numpy(),
        np.asarray(jmlp.mlp_forward(jparams, jbatch["x"])), rtol=1e-5,
        atol=1e-5)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jmlp.mlp_loss(p, jbatch), has_aux=True)(jparams)
    leaves = [t for layer in params for t in (layer["w"], layer["b"])]
    for t in leaves:
        t.requires_grad_()
    loss, metrics = mlp.mlp_loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["accuracy"].item() == float(jm["accuracy"])
    refs = [np.asarray(layer[k]) for layer in jgrads for k in ("w", "b")]
    for g, r in zip(grads, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_three_train_steps_match_jax():
    """make_train_step on the list of layer dicts against the JAX
    make_train_step (optax AdamW): loss, accuracy and grad_norm after
    each of three steps to 1e-5 relative, and the loss falls."""
    jcfg, jparams, cfg, params = _model(seed=2)
    jbatch, batch = _batch(3, 128, cfg)
    jtx = jtraining.make_optimizer(1e-3, warmup_steps=0)
    tx = training.make_optimizer(1e-3, warmup_steps=0)
    jstate = jtraining.init_train_state(jparams, jtx)
    state = training.init_train_state(params, tx)
    jstep = jtraining.make_train_step(jmlp.mlp_loss, jtx, donate=False)
    step = training.make_train_step(mlp.mlp_loss, tx)
    losses = []
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        losses.append(m["loss"].item())
    assert isinstance(state.params, list) and losses[-1] < losses[0]
