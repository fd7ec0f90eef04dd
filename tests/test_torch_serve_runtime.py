"""The port's Serve runtime (ray_tpu_torch.serve: controller, router,
replica, HTTP proxy) against the reference's (ray_tpu.serve): one
scenario serves the same plain deployments in each package, and the
replies, headers, stream bytes and status documents must be equal.

Each scenario brings its package up and takes it down (``serve.shutdown``
and the runtime's ``shutdown`` in ``finally``), so the two runtimes run
one after the other in one process and leave no serve thread behind.
Every blocking call carries a timeout.
"""

import http.client
import json
import socket
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as ref_serve
from ray_tpu_torch import serve as port_serve

_PACKAGES = {"ray_tpu": (ray_tpu, ref_serve),
             "ray_tpu_torch": (ray_tpu_torch, port_serve)}
_T = 30  # seconds: every blocking call's timeout

# The Block deployment parks on this until the scenario releases it.
_RELEASE = threading.Event()


class ParityEcho:
    def __init__(self, greeting):
        self.greeting = greeting

    def __call__(self, request):
        if isinstance(request, dict) and request.get("stream"):
            def tokens():
                for i in range(int(request.get("n", 3))):
                    yield {"i": i, "word": f"{self.greeting}-{i}"}
            return tokens()
        return {"greeting": self.greeting, "echo": request}


class ParityBlock:
    def __call__(self, request):
        _RELEASE.wait(_T)
        return {"released": True}


def _batched(serve):
    class ParityBatched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        def __call__(self, requests):
            return [{"x": r["x"], "batch": len(requests)}
                    for r in requests]

    return ParityBatched


def _post(conn, path, payload, headers=None):
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    return resp, resp.read()


def _raw(port, request: bytes) -> bytes:
    """One request on a fresh socket; the whole response as sent."""
    with socket.create_connection(("127.0.0.1", port), timeout=_T) as s:
        s.sendall(request)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


def _head(raw: bytes) -> dict:
    lines = raw.split(b"\r\n\r\n", 1)[0].decode().split("\r\n")
    out = {"status": lines[0]}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        out[k.strip().lower()] = v.strip()
    return out


def _scenario(rt, serve) -> dict:
    out = {}
    rt.shutdown()
    rt.init(num_cpus=4)
    _RELEASE.clear()
    try:
        handle = serve.run(
            serve.deployment(ParityEcho, name="ParityEcho").bind("hi"),
            route_prefix="/echo")
        proxy = serve.start_http_proxy()
        conn = http.client.HTTPConnection(proxy.host, proxy.port,
                                          timeout=_T)

        # JSON reply, with the headers a client reads.
        resp, body = _post(conn, "/echo", {"a": [1, 2]})
        out["json"] = (resp.status, resp.headers.get("Content-Type"),
                       json.loads(body))
        # A route that does not exist.
        resp, body = _post(conn, "/nowhere", {})
        out["404"] = (resp.status, body)
        # The handle, without HTTP.
        out["handle"] = rt.get(handle.remote({"h": 1}), timeout=_T)

        # A generator streams as SSE: the decoded body byte for byte,
        # and the framing on the wire (chunked) with it.
        resp, body = _post(conn, "/echo", {"stream": True, "n": 4})
        out["sse"] = (resp.status, resp.headers.get("Content-Type"),
                      resp.headers.get("Transfer-Encoding"), body)
        payload = json.dumps({"stream": True, "n": 2}).encode()
        raw = _raw(proxy.port,
                   b"POST /echo HTTP/1.1\r\nHost: t\r\nConnection: close"
                   b"\r\nContent-Type: application/json\r\n"
                   b"Content-Length: " + str(len(payload)).encode()
                   + b"\r\n\r\n" + payload)
        out["sse_wire"] = raw.split(b"\r\n\r\n", 1)[1]

        # X-Trace-Id: a token is echoed; a value that smuggles a bare
        # LF is refused and a fresh id minted, never echoed.
        resp, _ = _post(conn, "/echo", {}, {"X-Trace-Id": "trace-ok-1"})
        out["trace_echo"] = resp.headers.get("X-Trace-Id")
        raw = _raw(proxy.port,
                   b"POST /echo HTTP/1.1\r\nHost: t\r\nConnection: close"
                   b"\r\nX-Trace-Id: evil\nX-Injected: 1\r\n"
                   b"Content-Type: application/json\r\n"
                   b"Content-Length: 2\r\n\r\n{}")
        head = _head(raw)
        minted = head.get("x-trace-id", "")
        out["trace_reject"] = (head["status"], "x-injected" in head,
                               len(minted), "evil" in minted)

        # @serve.batch: four concurrent handle calls, one batch.
        bh = serve.run(serve.deployment(_batched(serve),
                                        name="ParityBatched").bind())
        out["batch"] = sorted(
            (r["x"], r["batch"]) for r in
            rt.get([bh.remote({"x": i}) for i in range(4)], timeout=_T))

        # 503 + Retry-After past max_in_flight.
        serve.run(serve.deployment(ParityBlock, name="ParityBlock",
                                   max_concurrent_queries=8).bind(),
                  route_prefix="/block")
        serve.start_http_proxy(max_in_flight=2, queue_timeout_s=1.0)
        req = (b"POST /block HTTP/1.1\r\nHost: t\r\nContent-Type: "
               b"application/json\r\nContent-Length: 2\r\n\r\n{}")
        parked = [socket.create_connection(("127.0.0.1", proxy.port),
                                           timeout=_T) for _ in range(2)]
        try:
            for s in parked:
                s.sendall(req)
            deadline = time.monotonic() + _T
            while proxy.stats()["in_flight"] < 2:
                assert time.monotonic() < deadline, proxy.stats()
                time.sleep(0.02)
            resp, body = _post(conn, "/block", {})
            out["503"] = (resp.status, resp.headers.get("Retry-After"),
                          proxy.stats()["shed_503"])
        finally:
            _RELEASE.set()
            for s in parked:
                s.close()
        serve.start_http_proxy(max_in_flight=256)

        # serve.status(), serve.delete and serve.shutdown.
        status = serve.status()
        out["status_names"] = sorted(status)
        out["status_keys"] = sorted(status["ParityEcho"])
        out["status_values"] = {k: status["ParityEcho"][k]
                                for k in ("status", "num_replicas")}
        serve.delete("ParityEcho")
        out["after_delete"] = sorted(serve.status())
        resp, body = _post(conn, "/echo", {})
        out["deleted_route"] = resp.status
        conn.close()
        serve.shutdown()
        try:
            rt.get_actor("SERVE_CONTROLLER")
            out["controller_after_shutdown"] = "alive"
        except ValueError:
            out["controller_after_shutdown"] = "gone"
    finally:
        _RELEASE.set()
        serve.shutdown()
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def observed():
    return {name: _scenario(*spec) for name, spec in _PACKAGES.items()}


_KEYS = ["json", "404", "handle", "sse", "sse_wire", "trace_echo",
         "trace_reject", "batch", "503", "status_names", "status_keys",
         "status_values", "after_delete", "deleted_route",
         "controller_after_shutdown"]


@pytest.mark.parametrize("key", _KEYS)
def test_serve_scenario_matches_reference(observed, key):
    ref, port = observed["ray_tpu"], observed["ray_tpu_torch"]
    assert key in ref, (key, sorted(ref))
    assert port.get(key) == ref[key]


def test_serve_observations_are_the_expected_ones(observed):
    """The equal observations are also the right ones."""
    port = observed["ray_tpu_torch"]
    assert port["json"] == (200, "application/json",
                            {"greeting": "hi", "echo": {"a": [1, 2]}})
    assert port["404"][0] == 404
    assert port["handle"] == {"greeting": "hi", "echo": {"h": 1}}
    status, ctype, te, body = port["sse"]
    assert (status, ctype, te) == (200, "text/event-stream", "chunked")
    events = [e for e in body.split(b"\n\n") if e]
    assert events[-1] == b"data: [DONE]"
    assert [json.loads(e[len(b"data: "):]) for e in events[:-1]] == [
        {"i": i, "word": f"hi-{i}"} for i in range(4)]
    assert port["trace_echo"] == "trace-ok-1"
    assert port["trace_reject"] == ("HTTP/1.1 200 OK", False, 32, False)
    assert port["batch"] == [(i, 4) for i in range(4)]
    assert port["503"][0] == 503 and port["503"][1] is not None
    assert port["status_names"] == ["ParityBatched", "ParityBlock",
                                    "ParityEcho"]
    assert port["status_values"] == {"status": "HEALTHY",
                                     "num_replicas": 1}
    assert port["after_delete"] == ["ParityBatched", "ParityBlock"]
    assert port["deleted_route"] == 404
    assert port["controller_after_shutdown"] == "gone"


def test_no_serve_thread_outlives_the_scenarios(observed):
    """Both runtimes are down: no long-poll, router, proxy or replica
    thread is left for a later test file in this worker to trip on."""
    deadline = time.monotonic() + _T
    names = ("longpoll", "serve", "router", "proxy", "replica",
             "raylet-dispatch")
    while True:
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and any(n in t.name for n in names)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert left == []
