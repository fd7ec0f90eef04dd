"""The port's ops (ray_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go to both frameworks. The JAX
side runs its Pallas kernels in interpret mode (as tests/ops/test_ops.py
does) or through its plain references; the port runs the plain version
that its wrappers take for CPU tensors.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import attention, norms, rope

# float32 on both sides, same formulas: the only differences are the
# order of f32 sums (the flash tiling, XLA's vs PyTorch's reductions),
# which stay within a few ulps at these sizes.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


# -- RMSNorm ----------------------------------------------------------------


def test_rms_norm_matches_jax_reference_and_pallas_interpret():
    r = _rng(0)
    x = r.standard_normal((4, 96, 256), np.float32)
    w = (r.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    ref = np.asarray(jnorms.rms_norm_reference(jnp.asarray(x),
                                               jnp.asarray(w)))
    pallas = np.asarray(jnorms.rms_norm_pallas(jnp.asarray(x),
                                               jnp.asarray(w),
                                               interpret=True))
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)


def test_rms_norm_bf16_matches_jax_reference():
    """bf16 in and out, f32 inside on both sides: the results may differ
    by one bf16 rounding (2**-8 relative) where the f32 values straddle a
    rounding boundary."""
    r = _rng(1)
    x32 = r.standard_normal((8, 64), np.float32)
    x = torch.from_numpy(x32).bfloat16()
    w = torch.ones(64, dtype=torch.bfloat16)
    got = norms.rms_norm(x, w, 1e-5).float().numpy()
    ref = jnorms.rms_norm_reference(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.ones(64, jnp.bfloat16), 1e-5)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=2 ** -8)


def test_layer_norm_matches_jax():
    r = _rng(2)
    x = r.standard_normal((8, 64), np.float32)
    w = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    got = norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b)).numpy()
    ref = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, **F32_TOL)


# -- flash attention forward ------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    # (b, sq, sk, h, h_kv, d, block): tests/ops/test_ops.py and
    # tests/core/test_advice_fixes.py:51 shapes — GQA, ragged 96/100.
    (1, 64, 64, 4, 2, 16, 64),
    (2, 96, 96, 4, 4, 16, 64),
    (1, 100, 100, 2, 2, 16, 64),
    (2, 48, 48, 2, 2, 32, 32),
    (2, 64, 100, 2, 2, 32, 32),
])
def test_flash_fwd_matches_jax_interpret(causal, shape):
    b, sq, sk, h, h_kv, d, block = shape
    r = _rng(3)
    q = r.standard_normal((b, sq, h, d), np.float32)
    k = r.standard_normal((b, sk, h_kv, d), np.float32)
    v = r.standard_normal((b, sk, h_kv, d), np.float32)
    scale = d ** -0.5
    o_ref, lse_ref = jattn._flash_fwd(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)),
        causal, scale, block, block, True)
    o, lse = attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=scale)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(o_ref).transpose(0, 2, 1, 3),
                               **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **F32_TOL)


def _cached_case(seed, b, t, s, h, h_kv, d, offsets):
    r = _rng(seed)
    q = r.standard_normal((b, t, h, d), np.float32)
    kc = r.standard_normal((b, s, h_kv, d), np.float32)
    vc = r.standard_normal((b, s, h_kv, d), np.float32)
    off = np.asarray(offsets, np.int32)
    pos = off[:, None] + np.arange(t, dtype=np.int32)[None, :]
    cfg = types.SimpleNamespace(n_heads=h, n_kv_heads=h_kv)
    ref = np.asarray(jllama._cached_attention(
        cfg, jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos)))
    return q, kc, vc, off, pos, ref


@pytest.mark.parametrize("t,offsets", [
    (12, [0, 0]),        # prefill from position 0
    (12, [3, 17]),       # prefill at ragged offsets > 0
    (1, [0, 31]),        # decode, T = 1
    (1, [5, 20]),
])
def test_flash_fwd_q_offset_matches_cached_attention(t, offsets):
    """With q_offset the flash forward computes llama._cached_attention:
    key j is visible to row i iff j <= q_offset + i."""
    q, kc, vc, off, _, ref = _cached_case(4, 2, t, 32, 4, 2, 16, offsets)
    o, lse = attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, sm_scale=16 ** -0.5, q_offset=torch.from_numpy(off))
    np.testing.assert_allclose(o.numpy(), ref, **F32_TOL)
    assert lse.shape == (2, 4, t) and np.isfinite(lse.numpy()).all()


def test_plain_attention_references_match_jax():
    q, kc, vc, _, pos, ref = _cached_case(5, 2, 6, 24, 4, 2, 16, [0, 9])
    got = attention.cached_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)

    r = _rng(6)
    qh = r.standard_normal((1, 4, 40, 16), np.float32)
    kh = r.standard_normal((1, 2, 40, 16), np.float32)
    vh = r.standard_normal((1, 2, 40, 16), np.float32)
    for causal in (True, False):
        got = attention.attention_reference(
            torch.from_numpy(qh), torch.from_numpy(kh),
            torch.from_numpy(vh), causal, 0.25)
        exp = jattn.attention_reference(jnp.asarray(qh), jnp.asarray(kh),
                                        jnp.asarray(vh), causal, 0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32_TOL)


def test_flash_fwd_refuses_grad():
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError):
        attention.flash_attention_fwd(q, k, k)


# -- RoPE -------------------------------------------------------------------


def test_rope_matches_jax():
    """f32 on both sides; pow/cos implementations differ by ulps, which
    position multiplies (positions < 128 here)."""
    tol = dict(rtol=1e-5, atol=2e-5)
    cos, sin = rope.rope_frequencies(16, 128)
    jcos, jsin = jrope.rope_frequencies(16, 128)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **tol)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **tol)

    r = _rng(7)
    x = r.standard_normal((2, 10, 4, 16), np.float32)
    pos = r.integers(0, 128, (2, 10)).astype(np.int32)
    got = rope.apply_rope(torch.from_numpy(x), cos, sin,
                          torch.from_numpy(pos))
    exp = jrope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **tol)
    got = rope.apply_rope(torch.from_numpy(x), cos, sin)
    exp = jrope.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **tol)

    c3, s3 = rope.rope_from_positions(torch.from_numpy(pos), 16)
    jc3, js3 = jrope.rope_from_positions(jnp.asarray(pos), 16)
    np.testing.assert_allclose(c3.numpy(), np.asarray(jc3), **tol)
    got = rope.apply_rope(torch.from_numpy(x), c3, s3)
    exp = jrope.apply_rope(jnp.asarray(x), jc3, js3)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **tol)


# -- flash attention backward -----------------------------------------------

# (b, sq, sk, h, h_kv, d): tests/ops/test_ops.py:77-106's grid (GQA, ragged
# q and k against the 64-row blocks), plus Sq != Sk, and the geometries the
# card's tensor-core kernels add at their tile edges: MHA with 8 heads, and
# 129 rows and keys (one past two 64-row tiles).
_BWD_SHAPES = [
    (1, 64, 64, 4, 2, 16),
    (2, 96, 96, 4, 4, 16),
    (1, 100, 100, 2, 2, 16),
    (1, 64, 64, 8, 8, 16),
    (1, 129, 129, 4, 2, 16),
]
_BWD_CASES = ([(s, causal) for s in _BWD_SHAPES for causal in (True, False)]
              + [((2, 48, 100, 4, 2, 16), False)])


def _bwd_inputs(shape, seed=7):
    b, sq, sk, h, h_kv, d = shape
    r = _rng(seed)
    return (r.standard_normal((b, sq, h, d), np.float32),
            r.standard_normal((b, sk, h_kv, d), np.float32),
            r.standard_normal((b, sk, h_kv, d), np.float32),
            r.standard_normal((b, sq, h, d), np.float32))


def _bhsd(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("shape,causal", _BWD_CASES)
def test_flash_bwd_reference_matches_jax_pallas_bwd(shape, causal):
    """The plain version of the dq and dk/dv kernels against the JAX
    package's _flash_bwd in interpret mode, on the forward's own o and
    lse. f32 on both sides, the same arithmetic: sums taken in another
    order (JAX per 64-row block, per query head then per GQA group), a
    few ulps of values of order 1-10 (F32_TOL)."""
    q, k, v, do = _bwd_inputs(shape)
    d = shape[-1]
    scale = d ** -0.5
    o, lse = jattn._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                              64, 64, True)
    ref = jattn._flash_bwd(_bhsd(q), _bhsd(k), _bhsd(v), o, lse, _bhsd(do),
                           causal, scale, 64, 64, True)
    got = attention.flash_attention_bwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.asarray(o).transpose(0, 2, 1, 3).copy()),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do),
        causal=causal, sm_scale=scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r).transpose(0, 2, 1, 3), **F32_TOL,
            err_msg=name)


@pytest.mark.parametrize("shape,causal", _BWD_CASES)
def test_flash_attention_autograd_matches_jax_vjp(shape, causal):
    """FlashAttention through autograd (the forward kernel's plain
    version, then the backward's) against jax.vjp of the JAX
    flash_attention run through its Pallas kernels in interpret mode.
    Same f32 arithmetic, sums in another order (F32_TOL)."""
    q, k, v, do = _bwd_inputs(shape, seed=8)

    def jflash(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, block_q=64,
                                     block_k=64, interpret=True)

    o_ref, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = attention.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               **F32_TOL)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **F32_TOL,
                                   err_msg=name)


def test_flash_attention_autograd_takes_an_expanded_cotangent():
    """``out.sum().backward()`` hands the backward a stride-0 cotangent."""
    q, k, v, _ = _bwd_inputs((1, 40, 40, 4, 2, 16), seed=9)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attention.flash_attention(tq, tk, tv).sum().backward()
    ones = np.ones_like(q)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, block_q=64, block_k=64, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for t, r in zip((tq, tk, tv), vjp(jnp.asarray(ones))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **F32_TOL)


# -- RMSNorm backward -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_closed_form_backward_matches_jax_grad(dtype):
    """rms_norm_bwd, the closed-form backward that RMSNorm's
    autograd.Function runs on the card after the forward kernel, against
    jax.vjp of the JAX rms_norm_reference, on the same x, w and cotangent
    g. f32: the closed
    form against XLA's derivative of the same expression, a few ulps
    (F32_TOL). bf16 (inputs and outputs rounded, f32 inside on both
    sides): one bf16 rounding of each output may differ where the f32
    values straddle a boundary, 2**-8 relative, and dw sums 96 rows."""
    r = _rng(10)
    x = r.standard_normal((96, 256), np.float32)
    w = (r.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
    g = r.standard_normal((96, 256), np.float32)
    eps = 1e-5
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    _, vjp = jax.vjp(lambda x, w: jnorms.rms_norm_reference(x, w, eps),
                     jx, jw)
    rdx, rdw = (np.asarray(t.astype(jnp.float32)) for t in vjp(jg))
    tx, tw, tg = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    dx, dw = norms.rms_norm_bwd(tx, tw, tg, eps)
    assert dx.dtype == tdt and dw.dtype == tdt
    tol = F32_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(dx.float().numpy(), rdx, **tol)
    dw_tol = tol if dtype == "float32" else dict(rtol=2 ** -7,
                                                 atol=2 ** -7 * 96 ** 0.5)
    np.testing.assert_allclose(dw.float().numpy(), rdw, **dw_tol)


# -- cross-entropy ----------------------------------------------------------


def test_softmax_cross_entropy_matches_jax():
    """Loss (tests/ops/test_ops.py:148's shape, block 256 over V 1000: a
    short last block) and gradient (:158's, block 128 over 500) against
    the JAX blockwise CE and its custom_vjp. f32 on both sides; the
    per-token logsumexp sums ~1000 exps in another order (F32_TOL)."""
    from ray_tpu.ops import cross_entropy as jce
    from ray_tpu_torch.ops import cross_entropy as ce

    r = _rng(11)
    logits = (r.standard_normal((32, 1000)) * 3).astype(np.float32)
    labels = r.integers(0, 1000, 32).astype(np.int32)
    got = ce.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 256)
    ref = jce.softmax_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(labels), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    np.testing.assert_allclose(
        ce.softmax_cross_entropy_reference(
            torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jce.softmax_cross_entropy_reference(
            jnp.asarray(logits), jnp.asarray(labels))), **F32_TOL)

    logits = r.standard_normal((16, 500)).astype(np.float32)
    labels = r.integers(0, 500, 16).astype(np.int32)
    t = torch.from_numpy(logits).requires_grad_()
    ce.softmax_cross_entropy(t, torch.from_numpy(labels), 128).mean() \
        .backward()
    ref = jax.grad(lambda l: jce.softmax_cross_entropy(
        l, jnp.asarray(labels), 128).mean())(jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("v,block", [(500, 128), (384, 128), (1000, 1000),
                                     (509, 128)])
def test_fused_linear_cross_entropy_matches_jax(v, block):
    """Loss and both gradients against JAX's fused_linear_cross_entropy at
    tests/ops/test_ops.py:171's shapes, plus V 509 (prime: no divisor
    near the block count, so JAX pads the last block). f32 on both sides;
    dW and dx sum over 24 tokens and V columns in another order
    (F32_TOL)."""
    from ray_tpu.ops import cross_entropy as jce
    from ray_tpu_torch.ops import cross_entropy as ce

    assert ce._flce_blocks(v, block) == jce._flce_blocks(
        jnp.zeros((1, v)), block)
    r = _rng(12)
    n, d = 24, 32
    x = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal((d, v)) * 0.1).astype(np.float32)
    labels = r.integers(0, v, n).astype(np.int32)
    g = r.standard_normal(n).astype(np.float32)
    jl = jnp.asarray(labels)
    ref, vjp = jax.vjp(
        lambda x, w: jce.fused_linear_cross_entropy(x, w, jl, block),
        jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = ce.fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                        block)
    dx, dw = torch.autograd.grad(got, (tx, tw), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **F32_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), **F32_TOL)


def test_fused_linear_cross_entropy_tied_layout():
    """w given as the transpose of a [V, D] table (tied embeddings): the
    loss and dW agree with the contiguous-w call, and dW comes back in
    w's own layout, so it adds into the table's gradient."""
    from ray_tpu_torch.ops import cross_entropy as ce

    r = _rng(13)
    x = torch.from_numpy(r.standard_normal((12, 16)).astype(np.float32))
    table = torch.from_numpy(
        (r.standard_normal((300, 16)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, 300, 12))
    t = table.clone().requires_grad_()
    ce.fused_linear_cross_entropy(x, t.T, labels, 128).sum().backward()
    w = table.T.contiguous().requires_grad_()
    ce.fused_linear_cross_entropy(x, w, labels, 128).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), w.grad.T.numpy(), **F32_TOL)
