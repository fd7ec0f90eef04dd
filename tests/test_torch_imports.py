"""The port stands alone: ray_tpu_torch loads neither jax nor anything of
ray_tpu, its entry points refuse to drop to the CPU quietly, and its CPU
path launches no kernel."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ray_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                          "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ray_tpu" or m.startswith("ray_tpu."))
print("MODULES", len(names))
print("NAMES", ",".join(sorted(names)))
print("BAD", bad)
"""


def test_fresh_interpreter_loads_no_jax_and_no_ray_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 15
    assert {"ray_tpu_torch.ops.cross_entropy",
            "ray_tpu_torch.models.training",
            "ray_tpu_torch.models.memory_plan",
            "ray_tpu_torch._private.kv_cache"} <= set(
        lines["NAMES"].split(","))
    assert lines["BAD"] == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|ray_tpu)(?:\.|\s|,|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO) for p in PKG.rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_no_source_imports_jax_or_ray_tpu(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(text), f"{path} imports jax or ray_tpu"


def test_entry_points_raise_without_cuda(monkeypatch):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.debug()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMDeployment(cfg, lambda: params, warmup=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_kv_cache(cfg, 1, 8)
    np_params = {k: v.numpy() if isinstance(v, torch.Tensor) else
                 {n: t.numpy() for n, t in v.items()}
                 for k, v in params.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.params_from_jax(np_params, cfg)


def test_cpu_path_leaves_launch_counts_at_zero():
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)
    from ray_tpu_torch.ops.norms import rms_norm

    def counts():
        return (flash_attention_fwd.launches, rms_norm.launches,
                flash_attention_bwd.dq_launches,
                flash_attention_bwd.dkv_launches)

    assert counts() == (0, 0, 0, 0)
    cfg = llama.LlamaConfig.debug()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = llama.init_kv_cache(cfg, 2, 16, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 4))
    logits, _ = llama.forward_with_cache(params, tokens, cfg, cache,
                                         torch.zeros(2, dtype=torch.int32))
    llama.forward(params, tokens, cfg)
    assert logits.shape == (2, 4, cfg.vocab_size)
    tx = training.make_optimizer(1e-3, warmup_steps=0)
    step = training.make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), tx)
    _, metrics = step(training.init_train_state(params, tx),
                      {"tokens": tokens, "targets": tokens})
    assert torch.isfinite(metrics["loss"])
    assert counts() == (0, 0, 0, 0)


def test_kernel_sources_are_listed_and_keyed_by_content():
    from ray_tpu_torch import _build

    srcs = _build.sources()
    assert set(srcs) == {"flash_fwd", "flash_bwd", "rms_norm"}
    paths = {name: _build._lib_path(src) for name, src in srcs.items()}
    assert len(set(paths.values())) == len(paths)
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so"
               for p in paths.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_bwd_args_need_aligned_bf16_q_and_do(dtype):
    """The bf16 backward kernels copy q and do rows as 16-byte pieces, so
    a q or do that starts off a 16-byte boundary is refused by name
    before any launch; the f32 kernels read it element by element."""
    from ray_tpu_torch.ops.attention import _check_bwd_args

    shape = (1, 4, 2, 64)
    k = torch.zeros(1, 4, 1, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 4)
    aligned = torch.zeros(shape, dtype=dtype)
    shifted = torch.zeros(aligned.numel() + 1, dtype=dtype)[1:].view(shape)
    assert shifted.data_ptr() % 16
    for label, q, do in (("q", shifted, aligned), ("do", aligned, shifted)):
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match=f"aligned {label}$"):
                _check_bwd_args(q, k, k, aligned, lse, do)
        else:
            _check_bwd_args(q, k, k, aligned, lse, do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_fwd_args_need_aligned_bf16_q(dtype):
    """The bf16 tensor-core forward copies q rows as 16-byte pieces, so a
    bf16 q that starts off a 16-byte boundary, or whose row stride is
    not a multiple of 16 bytes, is refused by name before any launch;
    the f32 kernels read q element by element and take it."""
    from ray_tpu_torch.ops.attention import _check_cuda_args

    shape = (1, 4, 2, 64)
    k = torch.zeros(1, 4, 1, 64, dtype=dtype)
    shifted = torch.zeros(512 + 1, dtype=dtype)[1:].view(shape)
    strided = torch.zeros(1, 4, 2, 68, dtype=dtype)[..., :64]
    assert shifted.data_ptr() % 16
    for q in (shifted, strided):
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="aligned q$"):
                _check_cuda_args(q, k, k, None)
        else:
            _check_cuda_args(q, k, k, None)
    _check_cuda_args(torch.zeros(shape, dtype=dtype), k, k, None)


def test_unknown_device_raises():
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)
    from ray_tpu_torch.ops.norms import rms_norm

    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rms_norm(x, torch.ones(8, device="meta"))
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_fwd(q, q, q)
    lse = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(q, q, q, q, lse, q)
