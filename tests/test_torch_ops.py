"""The port's ops (ray_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go to both frameworks. The JAX
side runs its Pallas kernels in interpret mode (as tests/ops/test_ops.py
does) or through its plain references; the port runs the plain version
that its wrappers take for CPU tensors.
"""

import types

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
