"""The LLM over HTTP in both packages: the scenario of
tests/serve/test_llm_serve.py (two shared-prefix SSE requests through
the proxy → router → replica path, then a replay) on the same tiny f32
model, the port's weights carried over from JAX with ``params_from_jax``
and served at ``device="cpu"``. Then a traced request, and two replicas
behind cache-affinity routing.

The tokens must be equal between the packages. The port's prefix-cache
hits, ``llm.*`` stages and affinity routing are read through its own
``perf_stats`` and ``critical_path``, the reference's through its own.
Every blocking call carries a timeout.
"""

import gc
import http.client
import json
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as ref_serve
from ray_tpu._private import critical_path as ref_cp
from ray_tpu._private import perf_stats as ref_stats
from ray_tpu._private.config import ray_config as ref_config
from ray_tpu.models import llama as jllama
from ray_tpu.serve._private import membership as ref_membership
from ray_tpu.serve.llm import LLMDeployment as RefLLMDeployment
from ray_tpu_torch import serve as port_serve
from ray_tpu_torch._private import critical_path as port_cp
from ray_tpu_torch._private import flight_recorder as port_fr
from ray_tpu_torch._private import health as port_health
from ray_tpu_torch._private import perf_stats as port_stats
from ray_tpu_torch._private.config import ray_config as port_config
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve._private import membership as port_membership
from ray_tpu_torch.models.training import _leaves
from ray_tpu_torch.serve.llm import LLMDeployment

_T = 60  # seconds: every blocking call's timeout
_DIMS = dict(vocab_size=64, dim=16, n_layers=1, n_heads=2, n_kv_heads=2,
             hidden_dim=32, max_seq_len=32, remat=False)
_SHARED = list(range(1, 13))  # 12 tokens = 3 full 4-token blocks
_STAGES = {"llm.admit", "llm.kv_lookup", "llm.prefill", "llm.first_token",
           "llm.decode"}


def _packages():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **_DIMS)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = llama.LlamaConfig(dtype=torch.float32, **_DIMS)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return {
        "ray_tpu": dict(rt=ray_tpu, serve=ref_serve, cp=ref_cp,
                        stats=ref_stats, config=ref_config,
                        membership=ref_membership,
                        cls=RefLLMDeployment, cfg=jcfg,
                        params=jparams, kw={}),
        "ray_tpu_torch": dict(rt=ray_tpu_torch, serve=port_serve,
                              cp=port_cp, stats=port_stats,
                              config=port_config,
                              membership=port_membership,
                              cls=LLMDeployment, cfg=cfg,
                              params=params, kw={"device": "cpu"}),
    }


def _sse_tokens(resp):
    toks, buf = [], b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        done = False
        while b"\n\n" in buf:
            line, buf = buf.split(b"\n\n", 1)
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            toks.append(json.loads(payload)["token"])
        if done:
            break
    return toks


def _stream(conn, prompt, headers=None):
    conn.request("POST", "/llm",
                 body=json.dumps({"prompt_ids": prompt, "max_tokens": 4,
                                  "stream": True}),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    status = resp.status
    toks = _sse_tokens(resp)
    resp.read()  # the chunk terminator: keep-alive stays intact
    return status, toks


def _counter(p, name):
    return p["stats"].counter(name).value


def _deploy(p, num_replicas):
    params = p["params"]
    return p["serve"].run(
        p["serve"].deployment(p["cls"], name="LLMParity",
                              num_replicas=num_replicas).bind(
            p["cfg"], lambda: params, max_batch_size=2, max_seq_len=32,
            warmup_max_prompt_len=16, **p["kw"]),
        route_prefix="/llm")


def _connect(p):
    proxy = p["serve"].start_http_proxy()
    return http.client.HTTPConnection(proxy.host, proxy.port, timeout=_T)


def _wait_affinity_ready(p, n_replicas):
    """Until the proxy's replica-direct table lists every replica and
    holds a prefix digest (the controller's digests:: channel)."""
    deadline = time.monotonic() + _T
    while time.monotonic() < deadline:
        for d in list(p["membership"]._DISPATCHERS):
            t = d.table
            if len(t._members) == n_replicas and any(
                    doc.get("keys") for doc in t._digests.values()):
                return
        time.sleep(0.02)
    raise AssertionError("no affinity digests reached the proxy")


def _engine_threads():
    return {t for t in threading.enumerate()
            if t.name == "llm-engine" and t.is_alive()}


def _wait_threads(want, before):
    """Until the engine threads started since ``before`` number
    ``want``; their count then."""
    deadline = time.monotonic() + _T
    while len(_engine_threads() - before) != want \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    return len(_engine_threads() - before)


def _scenario(p) -> dict:
    rt, serve = p["rt"], p["serve"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in (("llm_prefix_cache", True),
                           ("llm_kv_block_tokens", 4),
                           ("llm_prefix_shm_tier", False),
                           ("llm_digest_refresh_s", 0.05),
                           ("serve_replica_health_timeout_s", 30.0),
                           ("serve_replica_health_failures", 20)):
            mp.setattr(p["config"], key, value)
        # Record every stage, however short (the recorder drops spans
        # under MIN_SPAN_S, and a CPU lookup can take less).
        mp.setattr(p["cp"], "MIN_SPAN_S", 0.0)
        rt.shutdown()
        rt.init(num_cpus=4)
        try:
            # The test_llm_serve scenario: two shared-prefix streams,
            # the second hits the first's blocks, then a replay.
            threads0 = _engine_threads()
            handle = _deploy(p, 1)
            conn = _connect(p)
            hits0 = _counter(p, "llm_kv_cache_hits")
            out["streams"] = [_stream(conn, _SHARED + tail)
                              for tail in ([20, 21], [30, 31])]
            out["hits"] = _counter(p, "llm_kv_cache_hits") - hits0
            out["replay"] = _stream(conn, _SHARED + [30, 31])
            # The replica's affinity digest: the shared head's 3 keys.
            out["digest"] = rt.get(handle.prefix_digests.remote(),
                                   timeout=_T)

            # A traced request records the engine's stages.
            trace = "llm-parity-trace"
            out["traced"] = _stream(conn, [40, 41, 42],
                                    {"X-Trace-Id": trace})
            deadline = time.monotonic() + _T
            names = set()
            while time.monotonic() < deadline:
                names = {s["stage"] for s in
                         p["cp"].stage_spans_for_trace(trace)}
                if _STAGES <= names:
                    break
                time.sleep(0.02)
            out["stages"] = sorted(n for n in names
                                   if n.startswith("llm."))
            conn.close()
            serve.shutdown()
            out["engine_threads_after_shutdown"] = len(
                _engine_threads() - threads0)

            # Two replicas: after a primer lands somewhere, every request
            # that shares its head goes to the replica holding the
            # blocks (3 hits each); round-robin would send half away.
            _deploy(p, 2)
            conn = _connect(p)
            out["primer"] = _stream(conn, _SHARED + [20, 21])[0]
            _wait_affinity_ready(p, 2)
            hits0 = _counter(p, "llm_kv_cache_hits")
            aff0 = _counter(p, "serve_affinity_hits")
            out["affine_status"] = [_stream(conn, _SHARED + [t, t + 1])[0]
                                    for t in (50, 52, 54, 56)]
            out["affine_hits"] = (
                _counter(p, "llm_kv_cache_hits") - hits0,
                _counter(p, "serve_affinity_hits") - aff0)
            conn.close()
        finally:
            serve.shutdown()
            rt.shutdown()
    return out


@pytest.fixture(scope="module")
def observed():
    snaps = (port_cp.snapshot_state(), port_fr.snapshot_state(),
             port_health.snapshot_state())
    try:
        return {name: _scenario(p) for name, p in _packages().items()}
    finally:
        port_cp.restore_state(snaps[0])
        port_fr.restore_state(snaps[1])
        port_health.restore_state(snaps[2])


def test_sse_tokens_equal_between_packages(observed):
    ref, port = observed["ray_tpu"], observed["ray_tpu_torch"]
    assert port["streams"] == ref["streams"]
    assert all(status == 200 and len(toks) == 4
               for status, toks in port["streams"])
    assert port["traced"] == ref["traced"]


def test_shared_head_hits_the_ports_prefix_cache(observed):
    assert observed["ray_tpu_torch"]["hits"] >= 3
    assert observed["ray_tpu"]["hits"] >= 3


def test_replay_equals_the_cached_stream(observed):
    for name in ("ray_tpu", "ray_tpu_torch"):
        o = observed[name]
        assert o["replay"] == o["streams"][1], name
    assert observed["ray_tpu_torch"]["replay"] == \
        observed["ray_tpu"]["replay"]


def test_traced_request_records_the_same_llm_stages(observed):
    assert set(observed["ray_tpu_torch"]["stages"]) == _STAGES
    assert observed["ray_tpu_torch"]["stages"] == \
        observed["ray_tpu"]["stages"]


def test_prefix_digest_equals_the_reference(observed):
    """Same model seed, block size and tokens: the same chain keys, so
    the digest a replica exports for affinity routing is the
    reference's, key for key."""
    port, ref = observed["ray_tpu_torch"]["digest"], \
        observed["ray_tpu"]["digest"]
    assert port == ref
    assert port["block_tokens"] == 4 and len(port["keys"]) >= 3


def test_serve_shutdown_stops_the_replicas_engine(observed):
    """The port's replica calls its LLMDeployment's ``stop`` when it
    shuts down, so no engine loop (and no weights or KV cache) outlives
    ``serve.shutdown``; the reference has no such hook."""
    assert observed["ray_tpu_torch"]["engine_threads_after_shutdown"] == 0


def _live_deployments():
    from ray_tpu_torch._private.worker import global_worker

    return [weakref.ref(user) for actor in list(
        global_worker().backend._actors.values())
        if isinstance(user := getattr(getattr(actor, "instance", None),
                                      "callable", None), LLMDeployment)]


@pytest.mark.parametrize("teardown", ["delete", "shutdown"])
def test_a_retired_replica_stops_and_frees_its_engine(teardown):
    """``serve.delete`` or ``serve.shutdown`` of an LLM deployment stops
    its replica's engine loop in the port and lets go of the
    LLMDeployment (its weights and KV cache) while the runtime stays
    up."""
    p = _packages()["ray_tpu_torch"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_config, "serve_replica_health_timeout_s", 30.0)
        mp.setattr(port_config, "serve_replica_health_failures", 20)
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=4)
        try:
            before = _engine_threads()
            _deploy(p, 1)
            assert _wait_threads(1, before) == 1
            deployments = _live_deployments()
            assert len(deployments) == 1
            if teardown == "delete":
                port_serve.delete("LLMParity")
            else:
                port_serve.shutdown()
            assert _wait_threads(0, before) == 0
            gc.collect()
            assert deployments[0]() is None
        finally:
            port_serve.shutdown()
            ray_tpu_torch.shutdown()


def test_affinity_routes_the_shared_head_to_its_replica(observed):
    for name in ("ray_tpu", "ray_tpu_torch"):
        o = observed[name]
        assert o["primer"] == 200, name
        assert o["affine_status"] == [200] * 4, name
        assert o["affine_hits"] == (4 * 3, 4), name


def _knob_engine(p, **kw):
    if p["kw"]:
        from ray_tpu_torch.serve.llm import LLMEngine
    else:
        from ray_tpu.serve.llm import LLMEngine
    return LLMEngine(p["cfg"], p["params"], max_batch_size=1,
                     max_seq_len=32, **p["kw"], **kw)


@pytest.mark.parametrize("knobs", [
    {"llm_prefix_cache": True, "llm_kv_block_tokens": 4},
    {"llm_prefix_cache": False, "llm_kv_block_tokens": 8},
    {"llm_prefix_cache": True, "llm_kv_block_tokens": 64}], ids=str)
def test_engine_reads_its_knobs_from_ray_config(knobs):
    """Both engines take the cache knobs from their package's
    ray_config (a block of max_seq_len or more turns the cache off in
    both); the port's constructor argument, when given, overrides."""
    seen = {}
    for name, p in _packages().items():
        with pytest.MonkeyPatch.context() as mp:
            for key, value in knobs.items():
                mp.setattr(p["config"], key, value)
            engine = _knob_engine(p)
            seen[name] = (engine.block_tokens,
                          engine.prefix_cache is None)
    assert seen["ray_tpu_torch"] == seen["ray_tpu"]
    p = _packages()["ray_tpu_torch"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_config, "llm_kv_block_tokens", 8)
        engine = _knob_engine(p, kv_block_tokens=4, prefix_cache=True)
        assert engine.block_tokens == 4 and engine.prefix_cache is not None


def test_model_swap_counters_match_reference():
    """A two-model deployment alternating a, b, a counts the same swaps
    and the same loaded bytes per job in both packages."""
    seen = {}
    for name, p in _packages().items():
        stats = p["stats"]
        models = {"a": p["params"], "b": p["params"]}
        dep = p["cls"](p["cfg"], models=models, default_model="a",
                       max_batch_size=1, max_seq_len=32, warmup=False,
                       **p["kw"])
        try:
            swaps0 = stats.counter("llm_model_swaps").value
            bytes0 = stats.counter("llm_model_swap_bytes",
                                   {"job": "tenant-s"}).value
            for model in ("b", "a", "b"):
                dep({"prompt_ids": [1, 2, 3], "max_tokens": 2,
                     "model": model, "job": "tenant-s"})
            seen[name] = (
                stats.counter("llm_model_swaps").value - swaps0,
                stats.counter("llm_model_swap_bytes",
                              {"job": "tenant-s"}).value - bytes0)
        finally:
            dep.engine.stop()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  _leaves(_packages()["ray_tpu_torch"]["params"]))
    assert seen["ray_tpu_torch"] == seen["ray_tpu"] == (3, n_bytes)
