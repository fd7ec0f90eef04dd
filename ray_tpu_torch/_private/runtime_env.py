"""Runtime environments: per-task/actor execution environments.

Reference: `python/ray/_private/runtime_env/` (SURVEY.md §2.2) — plugins
for env_vars / working_dir / pip / conda / py_modules, created on demand
by the per-node agent. In the in-process runtime, `env_vars` and
`working_dir` apply around task execution (serialized by a lock — process
env is global); `pip`/`conda` validate and record, materializing only
when worker *processes* launch (job supervisors pass them through).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional

_env_lock = threading.Lock()

KNOWN_FIELDS = {"env_vars", "working_dir", "pip", "conda", "py_modules",
                "container", "config"}

_PLUGINS: Dict[str, "RuntimeEnvPlugin"] = {}


class RuntimeEnvPlugin:
    """Reference: `runtime_env/plugin.py` ABC."""

    name: str = ""
    priority: int = 10

    def validate(self, value: Any) -> None:
        pass

    @contextlib.contextmanager
    def apply(self, value: Any):
        yield


def register_plugin(plugin: RuntimeEnvPlugin):
    _PLUGINS[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    """Remove a plugin (raylint R7: the registry needs a bounded
    lifetime — tests register throwaway plugins and must be able to
    take them back out)."""
    _PLUGINS.pop(name, None)


class _EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"

    def validate(self, value):
        if not isinstance(value, dict):
            raise TypeError("env_vars must be a dict of str->str")

    @contextlib.contextmanager
    def apply(self, value: Dict[str, str]):
        saved: Dict[str, Optional[str]] = {}
        for k, v in value.items():
            saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        try:
            yield
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old


class _WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"

    def validate(self, value):
        if not isinstance(value, str):
            raise TypeError("working_dir must be a path string")

    @contextlib.contextmanager
    def apply(self, value: str):
        old = os.getcwd()
        os.chdir(value)
        try:
            yield
        finally:
            os.chdir(old)


class _PyModulesPlugin(RuntimeEnvPlugin):
    """py_modules: directories or zip files whose modules become
    importable for the task (reference `runtime_env/py_modules.py`; the
    reference additionally ships the files via GCS — here paths must be
    reachable on the executing node, e.g. a shared filesystem)."""

    name = "py_modules"

    def validate(self, value):
        if not isinstance(value, (list, tuple)) or not all(
                isinstance(p, str) for p in value):
            raise TypeError("py_modules must be a list of path strings")

    @contextlib.contextmanager
    def apply(self, value):
        import importlib
        import sys

        added = []
        for path in value:
            # Each entry names a module: a package dir or a single .py
            # imports via its PARENT directory; a zip goes on sys.path
            # itself (zipimport).
            p = os.path.abspath(path.rstrip("/"))
            if os.path.isfile(p) and p.endswith(".zip"):
                entry = p
            else:
                entry = os.path.dirname(p)
            sys.path.insert(0, entry)
            added.append(entry)
        importlib.invalidate_caches()
        try:
            yield
        finally:
            for entry in added:
                try:
                    sys.path.remove(entry)
                except ValueError:
                    pass


class _RecordedOnlyPlugin(RuntimeEnvPlugin):
    """pip/conda: validated + recorded; materialized by worker-process
    launchers (job supervisor), not applicable to in-process threads."""

    def __init__(self, name: str):
        self.name = name


for _p in (_EnvVarsPlugin(), _WorkingDirPlugin(), _PyModulesPlugin(),
           _RecordedOnlyPlugin("pip"), _RecordedOnlyPlugin("conda"),
           _RecordedOnlyPlugin("container"),
           _RecordedOnlyPlugin("config")):
    register_plugin(_p)


def validate_runtime_env(runtime_env: Optional[dict]) -> None:
    if not runtime_env:
        return
    unknown = set(runtime_env) - KNOWN_FIELDS
    if unknown:
        raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
    for key, value in runtime_env.items():
        plugin = _PLUGINS.get(key)
        if plugin:
            plugin.validate(value)


@contextlib.contextmanager
def applied_runtime_env(runtime_env: Optional[dict]):
    """Apply an env around a task body. Serialized: process env/cwd are
    global, so concurrent tasks with envs take turns."""
    if not runtime_env or not any(
            k in runtime_env
            for k in ("env_vars", "working_dir", "py_modules")):
        yield
        return
    with _env_lock:
        with contextlib.ExitStack() as stack:
            for key in ("working_dir", "py_modules", "env_vars"):
                if key in runtime_env:
                    stack.enter_context(
                        _PLUGINS[key].apply(runtime_env[key]))
            yield
