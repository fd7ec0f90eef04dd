"""The port's in-process core (ray_tpu_torch: init/remote/get/put/wait,
actors, kill, cancel) against the reference's (ray_tpu): one scenario
runs on each package, and what it observes must be equal.

The accelerator differs by design: the port counts CUDA devices as
``"GPU"`` and takes ``num_gpus``, the reference counts TPUs as ``"TPU"``
and takes ``num_tpus``. On this GPU-less host both requests are
infeasible, and the scenario names the resource in its observations
through one placeholder. Every blocking call carries a timeout.
"""

import re
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

_PACKAGES = {"ray_tpu": (ray_tpu, "num_tpus", "TPU"),
             "ray_tpu_torch": (ray_tpu_torch, "num_gpus", "GPU")}
_T = 30  # seconds: every blocking call's timeout


def _err(e: BaseException, accel: str) -> tuple:
    """An exception as (type name, message) with the task/actor ids and
    the accelerator's name taken out, so two packages compare."""
    # The remote traceback names each package's own files: cut it.
    msg = str(e).split("--- remote traceback ---")[0]
    msg = re.sub(r"\b[0-9a-f]{8}\b", "<id>", msg).replace(accel, "ACCEL")
    return type(e).__name__, msg


def _scenario(rt, accel_opt: str, accel: str) -> dict:
    out = {}
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        out["resources"] = sorted(rt.cluster_resources().items())

        @rt.remote
        def square(x):
            return x * x

        # Fan-out.
        out["fan_out"] = rt.get([square.remote(i) for i in range(16)],
                                timeout=_T)

        # Nested tasks with ObjectRef arguments: a top-level ref
        # arrives resolved, a ref inside a list arrives as a ref.
        @rt.remote
        def add(a, refs):
            return a + sum(rt.get(refs, timeout=_T))

        @rt.remote
        def fan(n):
            return rt.get([square.remote(i) for i in range(n)], timeout=_T)

        out["nested"] = rt.get(
            add.remote(square.remote(3), [square.remote(2),
                                          square.remote(4)]), timeout=_T)
        out["nested_fan"] = rt.get(fan.remote(5), timeout=_T)

        # Ordered actor calls, and a named actor found by name.
        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.options(name="parity-counter").remote(10)
        out["actor_calls"] = rt.get([c.inc.remote() for _ in range(8)],
                                    timeout=_T)
        found = rt.get_actor("parity-counter")
        out["named_actor"] = rt.get(found.inc.remote(), timeout=_T)
        try:
            rt.get_actor("no-such-actor")
        except Exception as e:  # noqa: BLE001 - the type is compared
            out["missing_actor"] = _err(e, accel)

        # wait(): the split by num_returns, and a timeout that expires.
        @rt.remote
        def slow(s):
            time.sleep(s)
            return s

        fast = [square.remote(i) for i in range(3)]
        late = slow.remote(2.0)
        ready, not_ready = rt.wait(fast + [late], num_returns=3,
                                   timeout=_T)
        out["wait_split"] = (len(ready), len(not_ready),
                             not_ready == [late])
        ready, not_ready = rt.wait([late], num_returns=1, timeout=0.01)
        out["wait_timeout"] = (len(ready), len(not_ready))
        out["wait_late"] = rt.get(late, timeout=_T)
        try:
            rt.wait([late, late], num_returns=1, timeout=_T)
        except Exception as e:  # noqa: BLE001
            out["wait_duplicate"] = _err(e, accel)

        # A remote exception is caught as its original type.
        @rt.remote
        def boom():
            raise KeyError("boom")

        try:
            rt.get(boom.remote(), timeout=_T)
        except KeyError as e:
            out["remote_error"] = _err(e, accel)
            out["remote_error_mro"] = [k.__name__ for k in type(e).__mro__
                                       if k.__module__ != "builtins"]

        # kill → ActorDiedError.
        victim = Counter.remote(0)
        rt.get(victim.inc.remote(), timeout=_T)
        rt.kill(victim)
        try:
            rt.get(victim.inc.remote(), timeout=_T)
        except Exception as e:  # noqa: BLE001
            out["killed"] = _err(e, accel)

        # put/get of numpy arrays, and a ref passed to a task.
        arr = np.arange(24, dtype=np.float32).reshape(4, 6)
        ref = rt.put(arr)
        got = rt.get(ref, timeout=_T)
        out["put_get"] = (got.dtype.str, got.shape, got.tolist())
        out["put_to_task"] = float(rt.get(
            rt.remote(lambda a: a.sum()).remote(ref), timeout=_T))

        # Misuse: a negative CPU request and an options typo.
        for label, opts in (("negative_cpus", {"num_cpus": -1}),
                            ("options_typo", {"num_cpu": 1})):
            try:
                square.options(**opts).remote(1)
            except Exception as e:  # noqa: BLE001
                out[label] = _err(e, accel)

        # An accelerator this host does not have: the task fails.
        try:
            rt.get(square.options(**{accel_opt: 1}).remote(2), timeout=_T)
        except Exception as e:  # noqa: BLE001
            out["infeasible"] = _err(e, accel)

        # Shutdown and a fresh init: the old actor is gone, work runs.
        rt.shutdown()
        out["after_shutdown"] = rt.is_initialized()
        rt.init(num_cpus=2)
        out["reinit"] = (rt.get(square.remote(7), timeout=_T),
                         sorted(rt.cluster_resources().items()))
        try:
            rt.get_actor("parity-counter")
        except Exception as e:  # noqa: BLE001
            out["named_after_reinit"] = _err(e, accel)
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def observed():
    return {name: _scenario(*spec) for name, spec in _PACKAGES.items()}


_KEYS = ["resources", "fan_out", "nested", "nested_fan", "actor_calls",
         "named_actor", "missing_actor", "wait_split", "wait_timeout",
         "wait_late", "wait_duplicate", "remote_error", "remote_error_mro",
         "killed", "put_get", "put_to_task", "negative_cpus",
         "options_typo", "infeasible", "after_shutdown", "reinit",
         "named_after_reinit"]


@pytest.mark.parametrize("key", _KEYS)
def test_core_scenario_matches_reference(observed, key):
    ref, port = observed["ray_tpu"], observed["ray_tpu_torch"]
    assert key in ref, (key, sorted(ref))
    assert port.get(key) == ref[key]


def test_scenario_observations_are_the_expected_ones(observed):
    """The equal observations are also the right ones (so two packages
    broken the same way do not pass)."""
    port = observed["ray_tpu_torch"]
    assert port["fan_out"] == [i * i for i in range(16)]
    assert port["nested"] == 9 + 4 + 16
    assert port["actor_calls"] == list(range(11, 19))
    assert port["named_actor"] == 19
    assert port["wait_split"] == (3, 1, True)
    assert port["wait_timeout"] == (0, 1)
    assert port["remote_error"][0] == "TaskError(KeyError)"
    assert port["killed"][0] == "ActorDiedError"
    assert port["negative_cpus"][0] == "ValueError"
    assert port["options_typo"][0] == "ValueError"
    assert "ACCEL" in port["infeasible"][1]
    assert port["after_shutdown"] is False
    assert port["reinit"] == (49, [("CPU", 2.0)])


def test_port_puts_and_gets_a_torch_tensor():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        got = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=_T)
        assert got.dtype == torch.bfloat16 and torch.equal(got, t)

        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        out = ray_tpu_torch.get(double.remote(t), timeout=_T)
        assert torch.equal(out, t * 2)
    finally:
        ray_tpu_torch.shutdown()


def test_port_counts_cuda_devices_as_gpu(monkeypatch):
    """init counts torch's CUDA devices under "GPU" (none here);
    num_gpus overrides the count, and a GPU task then runs."""
    ray_tpu_torch.shutdown()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def gpu_task():
            return "ran"

        assert ray_tpu_torch.get(gpu_task.remote(), timeout=_T) == "ran"
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
        assert ray_tpu_torch.nodes()[0]["Resources"]["GPU"] == 1.0
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("call", ["client_init", "client_server",
                                  "isolate_process"])
def test_paths_outside_the_port_raise(call):
    """Client mode and process isolation are not ported: each raises
    NotImplementedError naming its ROADMAP item, never a quiet stub."""
    ray_tpu_torch.shutdown()
    try:
        if call == "client_init":
            with pytest.raises(NotImplementedError, match="client mode"):
                ray_tpu_torch.init(address="127.0.0.1:1")
            assert not ray_tpu_torch.is_initialized()
        elif call == "client_server":
            with pytest.raises(NotImplementedError, match="client mode"):
                ray_tpu_torch.enable_client_server(port=0)
        else:
            ray_tpu_torch.init(num_cpus=2)

            @ray_tpu_torch.remote(isolate_process=True)
            def isolated():
                return 1

            with pytest.raises(NotImplementedError,
                               match="process isolation"):
                ray_tpu_torch.get(isolated.remote(), timeout=_T)
    finally:
        ray_tpu_torch.shutdown()
