"""The port's prefix/KV cache and multi-model serving (ray_tpu_torch.serve.llm)
on the CPU, against the JAX package: on LlamaConfig.debug() with JAX's
parameters carried across, greedy tokens with the cache on equal those
with it off and JAX's naive greedy decoding, the cache's edges (a prompt
that is an exact multiple of the block, a match cut back to fit the
slot, eviction, per-job charges) hold, and one deployment holding two
weight sets answers each request as that model's naive greedy does.
"""

import threading
import types

import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch._private.kv_cache import chain_keys
from ray_tpu_torch.serve.llm import (
    LLMDeployment,
    LLMEngine,
    ModelSwapDeadlineError,
    SamplingParams,
    UnknownModelError,
)
from tests.test_torch_serve_llm import _PAD, load_model


@pytest.fixture(scope="module")
def models():
    """Two weight sets of the debug model: JAX seeds 0 ("a") and 1 ("b")."""
    return {"a": load_model(0), "b": load_model(1)}


def _engine(cfg, params, **kw):
    kw.setdefault("max_seq_len", _PAD)
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("kv_block_tokens", 4)
    return LLMEngine(cfg, params, device="cpu", **kw)


def _spy_prefills(engine):
    """Record each prefill's (start, real tokens, bucket)."""
    calls = []
    prefill = engine._prefill

    def spy(tokens, slot, length, start=0):
        calls.append((start, length, tokens.shape[1]))
        return prefill(tokens, slot, length, start)

    engine._prefill = spy
    return calls


def _generate_on_clean_slots(engine, prompt, max_tokens):
    """One request on an idle engine whose KV slots were zeroed first, so
    a hit's head is in the slot only if it was copied in (a retired slot
    is the next one admitted, and would still hold an earlier prompt)."""
    for name in ("k", "v"):
        engine.cache[name].zero_()
    return engine.generate(prompt, SamplingParams(max_tokens=max_tokens))


def _block_nbytes(cfg, block_tokens):
    # k and v, f32, per token of every layer.
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4 \
        * block_tokens


def test_prefix_cache_greedy_identical_and_hits(models):
    cfg, params, naive_greedy = models["a"]
    shared = list(range(1, 18))  # 17 tokens: 4 full 4-token blocks + 1
    prompts = [shared + [50 + i] for i in range(4)]

    def run(cache_on):
        engine = _engine(cfg, params, prefix_cache=cache_on)
        calls = _spy_prefills(engine)
        try:
            outs = [_generate_on_clean_slots(engine, p, 6) for p in prompts]
        finally:
            engine.stop()
        return outs, engine.metrics(), calls

    off, m_off, calls_off = run(False)
    on, m_on, calls_on = run(True)
    assert "kv_cache" not in m_off
    assert on == off == [naive_greedy(p, 6) for p in prompts]
    stats = m_on["kv_cache"]
    assert stats["hits"] >= 3 * 4, stats  # 4 shared blocks x 3 requests
    assert stats["blocks"] > 0 and stats["bytes"] > 0
    # Each later request prefills only its 2-token tail, from offset 16.
    assert [c[0] for c in calls_off] == [0] * 4
    assert calls_on == [(0, 18, 32)] + [(16, 2, 2)] * 3


def test_block_multiple_prompt_keeps_one_block_as_tail(models):
    """A prompt of exactly 2 blocks of 16 tokens fully matches on its
    second run, but one real token must go through prefill: the last
    block is prefilled again, a 16-token tail from offset 16."""
    cfg, params, naive_greedy = models["a"]
    prompt = list(range(3, 35))
    engine = _engine(cfg, params, kv_block_tokens=16)
    calls = _spy_prefills(engine)
    try:
        outs = [_generate_on_clean_slots(engine, prompt, 4)
                for _ in range(2)]
    finally:
        engine.stop()
    assert outs == [naive_greedy(prompt, 4)] * 2
    assert calls == [(0, 32, 32), (16, 16, 16)]
    assert engine.metrics()["kv_cache"]["hits"] == 2


def test_copy_in_is_exact_and_tail_logits_match_full_prefill(models):
    """Transport: after a copy-in the slot's prefix equals the stored
    payloads bit for bit. Arithmetic: a copy-in plus the tail's prefill
    gives the last position's logits of a full prefill of the prompt (f32
    on the CPU: only the order of sums differs). The arena's free rows are
    shuffled first, so the blocks land in rows that are not consecutive
    and each run of rows is copied on its own."""
    import random

    import torch

    cfg, params, _ = models["a"]
    engine = _engine(cfg, params, max_batch_size=3)
    random.Random(0).shuffle(engine._free_rows)
    prompt = list(range(7, 30))  # 23 tokens: 5 blocks + 3
    try:
        engine.generate(prompt[:21] + [99], SamplingParams(max_tokens=2))
    finally:
        engine.stop()
    for name in ("k", "v"):
        engine.cache[name].zero_()
    m_tok, chain = engine._prefix_copy_in(types.SimpleNamespace(
        job="default"), 1, prompt)
    assert m_tok == 20 and len(chain) == 5
    held = engine.prefix_cache.lookup(chain)
    rows = [engine._kv_store[h.block_id] for h in held[:5]]
    assert rows == sorted(rows) and rows != list(range(rows[0], rows[0] + 5))
    payloads = engine._kv_arena[[engine._kv_store[h.block_id]
                                 for h in held[:5]]]  # [5, 2, L, bt, Hkv, D]
    engine.prefix_cache.release(held)
    for j, name in enumerate(("k", "v")):
        region = engine.cache[name][:, 1, :m_tok]
        want = payloads[:, j].transpose(0, 1).flatten(1, 2)
        assert torch.equal(region, want)
    tail = torch.tensor([prompt[m_tok:] + [0]])  # bucket 4
    got = engine._prefill(tail, 1, 3, m_tok)
    full = torch.zeros((1, 32), dtype=torch.long)
    full[0, :len(prompt)] = torch.tensor(prompt)
    want = engine._prefill(full, 2, len(prompt))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_match_cut_back_to_fit_the_slot(models):
    """10 blocks match, but the offset plus the tail's bucket must fit
    the 64-token slot: 40 + bucket(19) = 72 and 36 + bucket(23) = 68 do
    not, 32 + bucket(27) = 64 does, so the tail starts at 32."""
    cfg, params, naive_greedy = models["a"]
    primer = list(range(1, 46))  # 45 tokens, 11 blocks
    prompt = primer[:40] + list(range(100, 119))  # 59 tokens
    engine = _engine(cfg, params)
    calls = _spy_prefills(engine)
    try:
        engine.generate(primer, SamplingParams(max_tokens=2))
        got = _generate_on_clean_slots(engine, prompt, 4)
    finally:
        engine.stop()
    assert got == naive_greedy(prompt, 4)
    assert calls[1] == (32, 27, 32)
    assert engine.metrics()["kv_cache"]["hits"] == 10


def test_eviction_keeps_pinned_blocks_and_exact_output(models):
    """Room for 6 blocks and 5 prompts of 5 blocks each: blocks are
    evicted, but never the two that a reader holds, the host arena holds
    one row for each resident block's payload, and every answer is
    exact."""
    cfg, params, naive_greedy = models["a"]
    nb = _block_nbytes(cfg, 4)
    engine = _engine(cfg, params, prefix_cache_bytes=6 * nb)
    assert engine._block_nbytes == nb
    prompts = [list(range(10 * i + 1, 10 * i + 22)) for i in range(5)]
    results = [None] * len(prompts)
    try:
        results[0] = engine.generate(prompts[0], SamplingParams(max_tokens=3))
        pc = engine.prefix_cache
        head = chain_keys(prompts[0], 4, engine._chain_seed)[:2]
        held = pc.lookup(head)
        assert [h.key for h in held] == head

        def run(i):
            results[i] = engine.generate(prompts[i],
                                         SamplingParams(max_tokens=3))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(1, 5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = pc.stats()
        assert stats["evictions"] > 0, stats
        assert all(pc.contains(k) for k in head)
        # One arena row per resident block, none shared, the rest free.
        rows = list(engine._kv_store.values())
        assert len(rows) == len(set(rows)) == stats["blocks"]
        assert sorted(rows + engine._free_rows) == list(range(6))
        assert pc.resident_bytes <= 6 * nb
        pc.release(held)
        again = _generate_on_clean_slots(engine, prompts[0], 3)
    finally:
        engine.stop()
    assert results == [naive_greedy(p, 3) for p in prompts]
    assert again == results[0]


def test_job_charges(models):
    """The deployment passes "job" (or "job_id") to the engine, and each
    job is charged for the blocks it admitted; a head already resident
    charges nobody again."""
    cfg, params, _ = models["a"]
    dep = LLMDeployment(cfg, lambda: params, max_batch_size=2,
                        max_seq_len=_PAD, kv_block_tokens=4, warmup=False,
                        device="cpu")
    nb = _block_nbytes(cfg, 4)
    try:
        dep({"prompt_ids": list(range(1, 10)), "max_tokens": 2,
             "job": "alice"})                                # 2 blocks
        dep({"prompt_ids": list(range(20, 33)), "max_tokens": 2,
             "job_id": "bob"})                               # 3 blocks
        dep({"prompt_ids": list(range(40, 45)), "max_tokens": 2})  # 1
        dep({"prompt_ids": list(range(1, 10)) + [99], "max_tokens": 2,
             "job": "carol"})                                # 2, resident
    finally:
        dep.engine.stop()
    assert dep.engine.prefix_cache.charges() == {
        "alice": 2 * nb, "bob": 3 * nb, "default": nb}


@pytest.mark.parametrize("kw", [{"prefix_cache": False},
                                {"kv_block_tokens": _PAD}],
                         ids=["off", "block-fills-slot"])
def test_no_cache_no_kv_cache_metrics(models, kw):
    cfg, params, naive_greedy = models["a"]
    engine = _engine(cfg, params, **kw)
    prompt = list(range(1, 18))
    try:
        outs = [engine.generate(prompt, SamplingParams(max_tokens=4))
                for _ in range(2)]
    finally:
        engine.stop()
    assert engine.prefix_cache is None
    assert "kv_cache" not in engine.metrics()
    assert outs == [naive_greedy(prompt, 4)] * 2


def test_two_models_alternate_each_matches_its_jax_greedy(models):
    (cfg, pa, naive_a), (_, pb, naive_b) = models["a"], models["b"]
    naive = {"a": naive_a, "b": naive_b}
    loads = []

    def loader(name, params):
        def load():
            loads.append(name)
            return params
        return load

    dep = LLMDeployment(cfg, models={"a": loader("a", pa),
                                     "b": loader("b", pb)},
                        max_batch_size=2, max_seq_len=_PAD,
                        kv_block_tokens=4, warmup=False, device="cpu")
    swaps = []
    swap = dep.engine.swap_params
    dep.engine.swap_params = lambda p, m: (swaps.append(m), swap(p, m))
    prompts = [[3, 17, 42, 8, 9], [1, 2, 3], list(range(5, 25))]
    try:
        assert dep.default_model == "a" and dep.engine.model == "a"
        for p in prompts:
            for name in ("a", "b"):
                hits = dep.engine.metrics()["kv_cache"]["hits"]
                out = dep({"prompt_ids": p, "max_tokens": 5, "model": name})
                assert out["model"] == name
                assert out["tokens"] == naive[name](p, 5), (name, p)
                if name == "b":
                    # The same prompt ran on "a" just before: its blocks
                    # are resident, but keyed by "a"'s seed.
                    assert dep.engine.metrics()["kv_cache"]["hits"] == hits
        out = dep({"prompt_ids": prompts[0], "max_tokens": 5})
        assert out["model"] == "a" and out["tokens"] == naive_a(prompts[0], 5)
    finally:
        dep.engine.stop()
    assert swaps == ["b", "a"] * 3
    assert loads == ["a", "b"]  # each loader ran once


def test_unknown_model_for_request_or_default(models):
    cfg, params, _ = models["a"]
    with pytest.raises(UnknownModelError) as ei:
        LLMDeployment(cfg, models={"a": params}, default_model="z",
                      warmup=False, device="cpu")
    assert ei.value.model == "z" and ei.value.known == ["a"]
    with pytest.raises(ValueError, match="params_fn or models"):
        LLMDeployment(cfg, warmup=False, device="cpu")
    dep = LLMDeployment(cfg, models={"a": params}, max_seq_len=_PAD,
                        warmup=False, device="cpu")
    try:
        with pytest.raises(UnknownModelError) as ei:
            dep({"prompt_ids": [1, 2], "model": "z"})
        assert ei.value.known == ["a"]
        assert dep.engine.metrics()["unfinished"] == 0
    finally:
        dep.engine.stop()


def test_swap_params_refuses_a_busy_engine(models):
    (cfg, pa, naive_a), (_, pb, naive_b) = models["a"], models["b"]
    engine = _engine(cfg, pa, model="a")
    prompt = list(range(1, 30))
    try:
        it = engine.generate(prompt, SamplingParams(max_tokens=12),
                             stream=True)
        with pytest.raises(RuntimeError, match="non-idle"):
            engine.swap_params(pb, "b")
        assert list(it) == naive_a(prompt, 12)
        seed_a = engine._chain_seed
        engine.swap_params(pb, "b")
        assert engine.model == "b" and engine._chain_seed != seed_a
        assert engine.generate(prompt, SamplingParams(max_tokens=6)) \
            == naive_b(prompt, 6)
    finally:
        engine.stop()


def test_engine_refuses_a_request_for_another_model(models):
    (cfg, pa, naive_a), (_, pb, naive_b) = models["a"], models["b"]
    engine = _engine(cfg, pa, model="a")
    prompt = [4, 8, 15, 16]
    try:
        with pytest.raises(UnknownModelError) as ei:
            engine.generate(prompt, SamplingParams(max_tokens=3), model="b")
        assert ei.value.known == ["a"]
        assert engine.metrics()["unfinished"] == 0
        assert engine.generate(prompt, SamplingParams(max_tokens=3),
                               model="a") == naive_a(prompt, 3)
        engine.swap_params(pb, "b")
        assert engine.generate(prompt, SamplingParams(max_tokens=3),
                               model="b") == naive_b(prompt, 3)
    finally:
        engine.stop()


def test_swap_refused_while_a_stopped_engine_holds_requests(models,
                                                           monkeypatch):
    """A request queued on a stopped engine is never retired: a swap to
    another model raises instead of draining for ever under the swap
    lock, and once the loop runs again both models are served."""
    (cfg, pa, naive_a), (_, pb, naive_b) = models["a"], models["b"]
    dep = LLMDeployment(cfg, models={"a": pa, "b": pb}, max_seq_len=_PAD,
                        warmup=False, device="cpu")
    prompt = [5, 6, 7, 8, 9]
    try:
        dep.engine.stop()
        assert not dep.engine.running()
        monkeypatch.setattr(dep.engine, "start", lambda: None)
        queued = dep({"prompt_ids": prompt, "max_tokens": 4, "model": "a",
                      "stream": True})
        assert dep.engine.metrics()["unfinished"] == 1
        outcome = []

        def ask_b():
            try:
                dep({"prompt_ids": prompt, "max_tokens": 4, "model": "b"})
                outcome.append("served")
            except RuntimeError as e:
                outcome.append(e)

        t = threading.Thread(target=ask_b, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "the swap's drain hung"
        assert len(outcome) == 1 and isinstance(outcome[0], RuntimeError)
        assert "not running" in str(outcome[0])
        assert dep.engine.model == "a"
        monkeypatch.undo()
        # The next request restarts the loop, which serves the queued one.
        assert dep({"prompt_ids": prompt, "max_tokens": 4,
                    "model": "a"})["tokens"] == naive_a(prompt, 4)
        assert [d["token"] for d in queued] == naive_a(prompt, 4)
        assert dep({"prompt_ids": prompt, "max_tokens": 4,
                    "model": "b"})["tokens"] == naive_b(prompt, 4)
    finally:
        dep.engine.stop()


def test_swap_deadline_then_warm_retry(models):
    (cfg, pa, _), (_, pb, naive_b) = models["a"], models["b"]
    dep = LLMDeployment(cfg, models={"a": pa, "b": pb}, max_seq_len=_PAD,
                        model_swap_deadline_s=1e-9, warmup=False,
                        device="cpu")
    prompt = [5, 6, 7, 8, 9]
    try:
        with pytest.raises(ModelSwapDeadlineError) as ei:
            dep({"prompt_ids": prompt, "max_tokens": 4, "model": "b"})
        assert ei.value.model == "b"
        assert ei.value.took_s > ei.value.deadline_s == 1e-9
        # The swap completed: the retry is served without another.
        assert dep.engine.model == "b"
        out = dep({"prompt_ids": prompt, "max_tokens": 4, "model": "b"})
        assert out["tokens"] == naive_b(prompt, 4)
    finally:
        dep.engine.stop()


def test_multi_model_chain_seeds_never_cross_hit(models):
    """Identical prompts under two models give disjoint chains, and each
    engine's seed is the JAX engine's string for the same model."""
    cfg, params, _ = models["a"]
    jcfg = jllama.LlamaConfig.debug()
    toks = list(range(32))
    keys = {}
    for name in ("a", "b"):
        engine = _engine(cfg, params, model=name, kv_block_tokens=16)
        ref_seed = jllm.LLMEngine._seed_for(
            types.SimpleNamespace(cfg=jcfg, block_tokens=16), name)
        assert engine._chain_seed == ref_seed
        keys[name] = chain_keys(toks, 16, engine._chain_seed)
        engine.stop()
    assert keys["a"] and keys["b"] and not set(keys["a"]) & set(keys["b"])
