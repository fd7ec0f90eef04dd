"""The port's LLM engine (ray_tpu_torch.serve.llm) on the CPU, against the
JAX package's model: greedy tokens must be identical to naive greedy
decoding with the JAX forward (the ground truth of tests/serve/test_llm.py),
on LlamaConfig.debug() with the JAX parameters carried over.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.llm import (
    LLMDeployment,
    LLMEngine,
    PromptTooLongError,
    SamplingParams,
    UnknownModelError,
)

_PAD = 64  # every prompt + generation below fits


def load_model(seed):
    """LlamaConfig.debug() with JAX parameters from ``PRNGKey(seed)``
    carried into the port: ``(cfg, params, naive_greedy)``."""
    jcfg = jllama.LlamaConfig.debug()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = llama.LlamaConfig.debug()
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    fwd = jax.jit(lambda p, t: jllama.forward(p, t, jcfg))

    def naive_greedy(prompt, n_tokens):
        """Re-run the full JAX forward for every token. Tokens are padded
        to one length so the jit compiles once; the model is causal, so
        the logits at the last real position ignore the padding."""
        tokens = list(prompt)
        for _ in range(n_tokens):
            padded = np.zeros((1, _PAD), np.int32)
            padded[0, :len(tokens)] = tokens
            logits = fwd(jparams, jnp.asarray(padded))
            tokens.append(int(logits[0, len(tokens) - 1].argmax()))
        return tokens[len(prompt):]

    return cfg, params, naive_greedy


@pytest.fixture(scope="module")
def model():
    return load_model(0)


def _engine(cfg, params, **kw):
    kw.setdefault("max_seq_len", _PAD)
    return LLMEngine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_engine_greedy_matches_jax_naive(model, decode_steps):
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=2,
                     decode_steps=decode_steps)
    try:
        for prompt in ([3, 17, 42, 8], [1], list(range(5, 25))):
            got = engine.generate(prompt, SamplingParams(max_tokens=8))
            assert got == naive_greedy(prompt, 8)
    finally:
        engine.stop()


def test_engine_concurrent_requests(model):
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=4)
    prompts = [[1, 2, 3], [9, 8], [5, 5, 5, 5], [7], [11, 13], [2, 4, 6]]
    expected = [naive_greedy(p, 6) for p in prompts]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = engine.generate(prompts[i], SamplingParams(max_tokens=6))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    engine.stop()
    assert not any(t.is_alive() for t in threads)
    assert results == expected


def test_slot_exhaustion_parks_then_admits(model):
    """More concurrent requests than slots: the overflow parks in the
    queue and is admitted when a retirement frees a slot."""
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=2)
    prompts = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10]]
    expected = [naive_greedy(p, 4) for p in prompts]
    results = [None] * len(prompts)
    saw_queued = threading.Event()

    def worker(i):
        results[i] = engine.generate(prompts[i], SamplingParams(max_tokens=4))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not saw_queued.is_set():
        if engine.metrics()["queued"] > 0:
            saw_queued.set()
        time.sleep(0.001)
    for t in threads:
        t.join(timeout=60)
    engine.stop()
    assert saw_queued.is_set(), "5 requests over 2 slots never queued"
    assert results == expected


def test_retired_slot_reuse_never_leaks_prior_tokens(model):
    """One slot: a long request, then a short one in the same slot. Stale
    KV from the first beyond the second's length is never attended."""
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=1)
    long_prompt, short_prompt = list(range(1, 25)), [42, 7]
    try:
        assert engine.generate(long_prompt, SamplingParams(max_tokens=6)) \
            == naive_greedy(long_prompt, 6)
        assert engine.generate(short_prompt, SamplingParams(max_tokens=6)) \
            == naive_greedy(short_prompt, 6)
    finally:
        engine.stop()


def test_prompt_too_long_and_bad_tokens_rejected(model):
    cfg, params, _ = model
    engine = _engine(cfg, params, max_batch_size=2, max_seq_len=16)
    with pytest.raises(PromptTooLongError) as ei:
        engine.generate(list(range(1, 30)), SamplingParams(max_tokens=2))
    assert ei.value.n_tokens == 29 and ei.value.cap == 15
    with pytest.raises(ValueError, match="vocabulary"):
        engine.generate([1, cfg.vocab_size], SamplingParams(max_tokens=2))
    m = engine.metrics()
    assert m["queued"] == 0 and m["active_slots"] == 0
    engine.stop()


def test_streaming_metrics_and_warmup(model):
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=2, decode_steps=2)
    assert engine.warmup() >= 0.0
    stream = engine.generate([4, 2], SamplingParams(max_tokens=5),
                             stream=True)
    tokens = list(stream)
    assert tokens == naive_greedy([4, 2], 5)
    m = engine.metrics()
    assert m["active_slots"] == 0 and m["free_slots"] == 2
    assert m["prefills"] >= 1 and m["decode_forwards"] >= 2
    engine.stop()


def test_top_k_one_sampling_is_greedy(model):
    """Temperature sampling over a top-1 truncation can only pick the
    argmax: the sampler's top-k path reproduces greedy tokens (the first
    token is sampled without top-k, as in the JAX engine, so it is
    compared from the second token on)."""
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=2, seed=1)
    prompt = [8, 6, 7]
    got = engine.generate(prompt, SamplingParams(max_tokens=6,
                                                 temperature=0.7, top_k=1))
    engine.stop()
    assert len(got) == 6
    first = got[0]
    assert got[1:] == naive_greedy(prompt + [first], 5)


def test_deployment_request_contract(model):
    cfg, params, naive_greedy = model
    dep = LLMDeployment(cfg, lambda: params, max_batch_size=2,
                        max_seq_len=_PAD, device="cpu")
    try:
        out = dep({"prompt_ids": [3, 17, 42, 8], "max_tokens": 5})
        assert out["tokens"] == naive_greedy([3, 17, 42, 8], 5)
        assert out["model"] == "default"
        assert 0 <= out["ttft_s"] <= out["latency_s"]
        streamed = list(dep({"prompt_ids": [3, 17], "max_tokens": 3,
                             "stream": True}))
        assert [s["index"] for s in streamed] == [0, 1, 2]
        assert [s["token"] for s in streamed] == naive_greedy([3, 17], 3)
        stop = out["tokens"][1]
        out = dep({"prompt_ids": [3, 17, 42, 8], "max_tokens": 5,
                   "stop_token_ids": [stop], "priority": "interactive"})
        assert out["tokens"] == naive_greedy([3, 17, 42, 8], 2)
        with pytest.raises(UnknownModelError):
            dep({"prompt_ids": [1], "model": "other"})
    finally:
        dep.engine.stop()


def test_engine_on_cpu_runs_no_kernel(model):
    from ray_tpu_torch.ops.attention import flash_attention_fwd
    from ray_tpu_torch.ops.norms import rms_norm

    cfg, params, _ = model
    before = (flash_attention_fwd.launches, rms_norm.launches)
    engine = _engine(cfg, params, max_batch_size=1)
    engine.generate([1, 2], SamplingParams(max_tokens=3))
    engine.stop()
    assert (flash_attention_fwd.launches, rms_norm.launches) == before
    assert isinstance(engine.cache["k"], torch.Tensor)


# -- check_health and warmup(concurrent=...), the JAX deployment's API ------


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.005)
    return cond()


# The engine thread's exception is the point of the test.
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_check_health_fails_when_the_engine_loop_dies(model, monkeypatch):
    """A prefill that raises kills the engine loop while it should run:
    check_health then raises (the JAX deployment's health ping would
    fail), where before it passed."""
    cfg, params, _ = model
    dep = LLMDeployment(cfg, lambda: params, max_batch_size=2,
                        max_seq_len=_PAD, warmup=False, device="cpu")
    try:
        dep.check_health()  # a live loop

        def broken(*args, **kwargs):
            raise RuntimeError("prefill failed")

        monkeypatch.setattr(dep.engine, "_prefill", broken)
        # Not read: the loop dies before its first token.
        dep.engine.generate([1, 2, 3], SamplingParams(max_tokens=2),
                            stream=True)
        assert _wait_for(lambda: not dep.engine.running())
        with pytest.raises(RuntimeError, match="engine loop died"):
            dep.check_health()
    finally:
        dep.engine.stop()
    dep.check_health()  # stopped on purpose: healthy again


def test_check_health_passes_for_a_stopped_or_unstarted_engine(model):
    cfg, params, naive_greedy = model
    dep = LLMDeployment(cfg, lambda: params, max_batch_size=2,
                        max_seq_len=_PAD, warmup=False, device="cpu")
    assert dep({"prompt_ids": [3, 17], "max_tokens": 2})["tokens"] \
        == naive_greedy([3, 17], 2)
    dep.check_health()
    dep.engine.stop()
    assert not dep.engine.running()
    dep.check_health()


@pytest.mark.parametrize("concurrent", [True, False])
def test_warmup_takes_concurrent(model, concurrent):
    """warmup(max_prompt_len, concurrent) has the JAX engine's signature;
    ``concurrent`` changes nothing here, and the engine then serves the
    JAX naive greedy tokens."""
    cfg, params, naive_greedy = model
    engine = _engine(cfg, params, max_batch_size=2)
    assert engine.warmup(8, concurrent=concurrent) >= 0.0
    assert engine.warmup(max_prompt_len=4, concurrent=concurrent) >= 0.0
    try:
        assert engine.generate([4, 2, 9], SamplingParams(max_tokens=4)) \
            == naive_greedy([4, 2, 9], 4)
    finally:
        engine.stop()
