"""ray_tpu_torch.serve: online model serving on actors.

Reference `python/ray/serve/` (SURVEY.md §2.4 + §3.4 request path):
`@serve.deployment` → `serve.run` → detached controller reconciles
replica actors; handles route via client-side routers fed by long-poll;
`@serve.batch` batches concurrent calls; an HTTP proxy fronts handles.
LLM serving (continuous batching with a prefix/KV cache, on the GPU)
lives in `ray_tpu_torch.serve.llm`. The proxy fleet (`proxy_actor`) and
the declarative config (`schema`) are not ported yet.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve._private.controller import (
    CONTROLLER_NAME,
    get_or_create_controller,
)
from ray_tpu_torch.serve._private.http_proxy import HTTPProxy
from ray_tpu_torch.serve._private.router import ServeHandle
from ray_tpu_torch.serve.streaming import (  # noqa: F401
    aiter_stream,
    is_stream,
    iter_stream,
)

_proxy: Optional[HTTPProxy] = None


@dataclass
class Deployment:
    """Result of @serve.deployment; `.bind()`/`.options()` mirror the
    reference's deployment DSL (`serve/deployment.py`)."""

    func_or_class: Any
    name: str
    num_replicas: int = 1
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    user_config: Any = None
    max_concurrent_queries: int = 100
    ray_actor_options: Optional[dict] = None
    autoscaling_config: Optional[dict] = None
    route_prefix: Optional[str] = None
    version: Optional[str] = None

    def options(self, **kwargs) -> "Deployment":
        import dataclasses as dc

        known = {f.name for f in dc.fields(Deployment)}
        clean = {k: v for k, v in kwargs.items() if k in known}
        return dc.replace(self, **clean)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def deploy(self, *init_args, **init_kwargs):
        return run(self.bind(*init_args, **init_kwargs),
                   route_prefix=self.route_prefix)


@dataclass
class Application:
    deployment: Deployment
    args: tuple
    kwargs: dict


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, init_args: tuple = (),
               init_kwargs: Optional[dict] = None, user_config: Any = None,
               max_concurrent_queries: int = 100,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None,
               route_prefix: Optional[str] = None,
               version: Optional[str] = None, **_ignored):
    """`@serve.deployment` (reference `serve/api.py`)."""

    def wrap(obj):
        return Deployment(
            func_or_class=obj, name=name or obj.__name__,
            num_replicas=num_replicas, init_args=init_args,
            init_kwargs=init_kwargs or {}, user_config=user_config,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=ray_actor_options,
            autoscaling_config=autoscaling_config,
            route_prefix=route_prefix, version=version)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def run(target, *, name: str = "default", route_prefix: Optional[str] = None,
        _blocking: bool = True) -> ServeHandle:
    """Deploy an Application — or a *deployment graph*: bound arguments
    that are themselves Applications deploy first and arrive in the
    parent's constructor as ServeHandles, composing multi-model
    pipelines (reference: `serve/_private/deployment_graph_build.py` +
    `serve/drivers.py` DAGDriver)."""
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects a bound deployment, got "
                        f"{type(target)}")
    handle = _deploy_application(target, {}, _blocking)
    dep = target.deployment
    prefix = route_prefix if route_prefix is not None else dep.route_prefix
    if prefix is not None:
        start_http_proxy().routes.set(prefix, handle)
        # Route table lives on the controller too: proxy-actor fleets
        # (HTTPProxyActor) learn it via the "routes" long-poll channel.
        controller = get_or_create_controller()
        ray_tpu_torch.get(controller.set_route.remote(prefix, dep.name))
    return handle


def _resolve_bound(value, seen: dict, blocking: bool):
    if isinstance(value, Application):
        return _deploy_application(value, seen, blocking)
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_bound(v, seen, blocking)
                           for v in value)
    if isinstance(value, dict):
        return {k: _resolve_bound(v, seen, blocking)
                for k, v in value.items()}
    return value


def _deploy_application(app: Application, seen: dict,
                        blocking: bool = True) -> ServeHandle:
    """Deploy one node of a graph (children first, depth-first). The
    same bound node appearing twice (diamond graphs) deploys once."""
    if id(app) in seen:
        return seen[id(app)]
    dep = app.deployment
    init_args = tuple(_resolve_bound(a, seen, blocking) for a in app.args)
    init_kwargs = {k: _resolve_bound(v, seen, blocking)
                   for k, v in app.kwargs.items()}
    controller = get_or_create_controller()
    info = {
        "cls": dep.func_or_class,
        "init_args": init_args,
        "init_kwargs": init_kwargs,
        "num_replicas": dep.num_replicas,
        "user_config": dep.user_config,
        "max_concurrent_queries": dep.max_concurrent_queries,
        "ray_actor_options": dep.ray_actor_options,
        "autoscaling_config": dep.autoscaling_config,
        "version": dep.version,
    }
    ray_tpu_torch.get(controller.deploy.remote(dep.name, info))
    if blocking:
        _wait_healthy(controller, dep.name)
    handle = ServeHandle(controller, dep.name,
                         dep.max_concurrent_queries)
    seen[id(app)] = handle
    return handle


def _wait_healthy(controller, name: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = ray_tpu_torch.get(controller.get_deployment_info.remote(name))
        if info and info["status"] == "HEALTHY":
            return
        time.sleep(0.02)
    raise TimeoutError(f"deployment {name} not healthy after {timeout}s")


@deployment
class DAGDriver:
    """HTTP entry point for a deployment graph (reference:
    `serve/drivers.py` DAGDriver): routes each request into the bound
    graph's root handle and returns its result.

    Usage::

        graph = Combiner.bind(ModelA.bind(), ModelB.bind())
        serve.run(serve.DAGDriver.bind(graph), route_prefix="/pipeline")
    """

    def __init__(self, root_handle, http_adapter=None):
        self.root = root_handle
        self.http_adapter = http_adapter

    def __call__(self, request=None):
        if self.http_adapter is not None:
            request = self.http_adapter(request)
        ref = self.root.remote(request) if request is not None \
            else self.root.remote()
        return ray_tpu_torch.get(ref, timeout=60)


def get_deployment_handle(name: str, *_args, **_kwargs) -> ServeHandle:
    controller = get_or_create_controller()
    info = ray_tpu_torch.get(controller.get_deployment_info.remote(name))
    if info is None:
        raise ValueError(f"deployment {name!r} not found")
    return ServeHandle(controller, name)


def get_app_handle(name: str) -> ServeHandle:
    return get_deployment_handle(name)


def status() -> Dict[str, Any]:
    controller = get_or_create_controller()
    names = ray_tpu_torch.get(controller.list_deployments.remote())
    return {
        n: ray_tpu_torch.get(controller.get_deployment_info.remote(n))
        for n in names
    }


def delete(name: str):
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name))
    # Retract the deployment's routes everywhere: the controller table
    # (proxy-actor fleets long-poll it) and the driver-local proxy.
    ray_tpu_torch.get(controller.remove_routes_of.remote(name))
    if _proxy is not None:
        for prefix, handle in list(_proxy.routes._routes.items()):
            if getattr(handle, "_deployment", None) == name:
                _proxy.routes.remove(prefix)


def start_http_proxy(host: str = "127.0.0.1", port: int = 0,
                     **proxy_options) -> HTTPProxy:
    """Driver-local ingress. ``proxy_options`` forward to
    :class:`HTTPProxy` (``max_in_flight``, ``queue_timeout_s``,
    ``idle_timeout_s``); on an already-running proxy (serve.run starts
    one for any routed deployment) they reconfigure it in place —
    they're read per-request, so the change applies immediately."""
    global _proxy
    if _proxy is None:
        _proxy = HTTPProxy(host, port, **proxy_options)
    else:
        allowed = ("max_in_flight", "queue_timeout_s", "idle_timeout_s",
                   "result_timeout_s")
        unknown = [k for k in proxy_options if k not in allowed]
        if unknown:  # validate ALL keys before mutating any (atomic)
            raise TypeError(f"unknown proxy option(s) {unknown!r}")
        for key, value in proxy_options.items():
            setattr(_proxy, key, value)
    return _proxy


def shutdown():
    global _proxy
    from ray_tpu_torch.serve._private.membership import (
        shutdown_all_dispatchers,
        shutdown_all_watches,
    )
    from ray_tpu_torch.serve._private.router import shutdown_all_routers
    from ray_tpu_torch.serve.batching import retire_all_batchers

    # Routers first: their stop flags must be set before the
    # controller dies so the long-poll threads exit on the resulting
    # error instead of re-resolving a replacement controller. Direct
    # dispatchers and any orphaned membership watches go down with
    # them (watches stop on last unsubscribe; the sweep below catches
    # subscribers that never unsubscribed).
    shutdown_all_routers()
    shutdown_all_dispatchers()
    shutdown_all_watches()
    retire_all_batchers()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.graceful_shutdown.remote())
        ray_tpu_torch.kill(controller)
    except ValueError:
        pass
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None
