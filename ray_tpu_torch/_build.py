"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The output lands in ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the library already there. All missing libraries are
compiled together, one ``nvcc`` process per source. A failed build
raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources() -> Dict[str, Path]:
    """Kernel name → its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH)")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel whose library is missing, all ``nvcc``
    processes at once, and load them. Returns the seconds each new build
    took (empty when everything was already built and loaded)."""
    with _lock:
        todo = {name: src for name, src in sources().items()
                if name not in _libs}
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in todo.items():
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp, out, time.perf_counter())
        seconds = {}
        errors = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                              f"{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic against a concurrent build
        if errors:
            raise KernelBuildError("\n".join(errors))
        for name, src in todo.items():
            _libs[name] = ctypes.CDLL(str(_lib_path(src)))
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first
    use."""
    if name not in _libs:
        build_all()
    if name not in _libs:
        raise KernelBuildError(f"no kernel source csrc/{name}.cu")
    return _libs[name]
