#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, each printing one JSON line:

1. device  — the card's name, count and power limit (nvidia-smi).
2. build   — compiles every kernel under ray_tpu_torch/csrc/ (one nvcc
             per source, all at once) and prints the build seconds.
3. resources — registers and spills (nvcc -Xptxas -v) and HMMA count
             (cuobjdump -sass) of every kernel; each tensor-core kernel
             must show HMMA and no spill.
4. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving and training paths' shapes, with the
             stated tolerance, and times kernel and one PyTorch library
             call (yardstick only; the median of 5 ten-launch means,
             with min and max) and the plain version beside the least
             time the card could take (bound). The flash kernels run
             every instantiation their wrappers accept (bf16 and f32,
             head_dim 64 and 128, causal and not, ragged Sq and Sk, the
             8-row decode tile) and the bf16 tensor-core kernels' tile
             edges (MHA, a group of 8, Sq or Sk one past a tile, a short
             block at the end of a full cache), and a prefix-cache hit's
             tail prefills at offset 1024 (4 rows, 512 rows).
5. serve   — LLMDeployment on Llama-3.2-1B (full width and depth, random
             weights from --seed, the prefix cache on), answering
             concurrent requests; checks every answer and that the main
             path launched each kernel the expected number of times;
             prints tokens/s, TTFT p50, the decode step time, the
             cache's stats and its host ms.
6. prefix  — the prefix cache at full width and depth: one 1024-token
             head shared by 12 requests (the primer alone, then 11 at
             once; 4-token and 40-300-token tails), on three fresh
             engines: the cache off, on, and on with room for 96 blocks
             (evictions). Checks the hits (>= 11 x 64), evictions,
             launches per forward, that a copy-in puts the stored bytes
             in the slot exactly, that a copy-in plus the tail's prefill
             gives the logits of the same kernels without the cache bit
             for bit and a full prefill's within twice the measured
             spread of one rounding flip, that planted faults break the
             bit-exact check, and greedy tokens equal to the cache-off
             leg's (or first diverging where the top-2 margin is under
             twice that limit); prints TTFT p50, tokens/s and the
             cache's host ms per leg.
7. models  — one LLMDeployment holding two 1B weight sets: requests
             alternate between them; each reply must equal a one-model
             deployment's, a model must get no hit from the other's
             blocks, and each alternation must swap once; prints the
             swap ms.
8. logits  — one prompt's prefill and 4 decode steps of the 1B model cut
             to 2 layers, on the card (bf16, kernels) against the CPU
             (f32, plain versions).
9. grads   — loss_fn and the gradient of every parameter of the 1B model
             cut to 2 layers, on the card (bf16, kernels) against the CPU
             (f32, plain versions), each leaf held to its own limit; and
             the same on the card with remat="gate" against remat=False
             on the card, to 1e-6 of each leaf (the same bf16 ops).
10. train  — three AdamW steps of Llama-3.2-1B at full width and depth at
             bench.py's configuration (remat="gate", batch 4 x 2048
             tokens, bf16 moments, fused CE; one fixed random batch)
             through make_train_step; checks finite, falling loss and the
             launches of every kernel in each step (the flash forward once
             per layer: it is saved across the checkpoint, not rerun);
             prints step time, tokens/s, peak memory, and a profiled
             fourth step's top kernels.
11. memory — at each of remat=False, True, "gate" and "mlp": the peak
             memory of the forward and backward alone, then of two whole
             steps, each from a fresh reset, beside plan_llama's
             prediction and their ratio; the second step's time and a
             third step's device busy time (profiler); and the host's
             time per step, read at 1 x 128 tokens, where the card
             waits on the host. Checks the forward and backward's peaks
             in the order False > "mlp" > "gate" > True, each within
             0.8-1.25 of the plan, and every checkpointing mode's
             whole-step peak below remat=False's.

Then each phase's wall seconds, the kernels line and, last, ``{"ok":
true, "device": {...}}``. Any
failed check exits non-zero before the last line; with no CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import re
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, per type


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# Device-side wait between the L2 flush and the start event: ~0.5 ms at
# the H100's clocks, longer than any wrapper's host work, so that the
# launches of a timed call are enqueued before the card reaches its start
# event and the reading is the card's time, not the host's.
SLEEP_CYCLES = 1_000_000


def make_timer(torch):
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn, iters: int = 10) -> float:
        """Mean device time of ``fn`` over ``iters`` runs, each with a
        cold L2, from CUDA events. The L2 is made cold by a 128 MiB
        write; then the card sleeps ``SLEEP_CYCLES`` while the host
        enqueues ``fn``."""
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def time_stats(fn, repeats: int = 5) -> dict:
        """``time_ms`` repeated ``repeats`` times: the median with the
        min, the max and every reading."""
        runs = [time_ms(fn) for _ in range(repeats)]
        return {"median": statistics.median(runs), "min": min(runs),
                "max": max(runs), "runs": runs}

    time_ms.stats = time_stats
    return time_ms


# -- phase 3: what each kernel compiled to --------------------------------------


def kernel_resources(build):
    """Registers and spills of every kernel (``nvcc -Xptxas -v``, the
    build's flags, into a cubin beside the libraries) and its ``HMMA``
    count (``cuobjdump -sass`` of the library the build loaded), one
    ``nvcc`` per source, all at once. Every tensor-core kernel must show
    ``HMMA`` and no spill."""
    nvcc = Path(build._nvcc())
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    out_dir = build.BUILD_DIR.parent / "resources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [str(nvcc), *flags, "-cubin", "-Xptxas", "-v",
         "-o", str(out_dir / f"{name}.cubin"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in build.sources().items()}
    kernels = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc -Xptxas -v {name}: {log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                kernels[entry] = {"source": name}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and entry:
                kernels[entry]["spill_stores"] = int(m.group(1))
                kernels[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                kernels[entry]["registers"] = int(m.group(1))
        sass = subprocess.run(
            [str(nvcc.with_name("cuobjdump")), "-sass",
             str(build._lib_path(build.sources()[name]))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                kernels.setdefault(fn, {"source": name})
                kernels[fn].setdefault("hmma", 0)
            elif fn and "HMMA" in line:
                kernels[fn]["hmma"] += 1
    demangled = list(kernels)  # mangled, where cu++filt is missing
    cxxfilt = nvcc.with_name("cu++filt")
    if cxxfilt.exists():
        demangled = subprocess.run(
            [str(cxxfilt)], input="\n".join(kernels), capture_output=True,
            text=True, timeout=60, check=True).stdout.splitlines()
        check(len(demangled) == len(kernels), "cu++filt output")
    rows = {pretty: kernels[mangled]
            for pretty, mangled in zip(demangled, kernels)}
    emit({"phase": "resources", "tool": "nvcc -Xptxas -v; cuobjdump -sass",
          "kernels": rows})
    for pretty, r in rows.items():
        if "_tc_kernel" in pretty:
            check(r.get("hmma", 0) > 0 and r.get("spill_stores") == 0
                  and r.get("spill_loads") == 0,
                  f"{pretty}: {r} (a tensor-core kernel must show HMMA "
                  "and no spill)")
    return rows


# -- phase 4: kernels against their plain versions ---------------------------


def flash_checks(torch, seed, time_ms):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (flash_attention_fwd,
                                             flash_attention_fwd_reference)

    def case(label, b, sq, sk, offsets, causal, dtype, d=64, h=32, h_kv=8,
             slot_of=None):
        g = torch.Generator("cuda").manual_seed(seed)
        q = torch.randn((b, sq, h, d), generator=g, device="cuda",
                        dtype=torch.float32).to(dtype)
        if slot_of is None:
            k = torch.randn((b, sk, h_kv, d), generator=g, device="cuda",
                            dtype=torch.float32).to(dtype)
            v = torch.randn((b, sk, h_kv, d), generator=g, device="cuda",
                            dtype=torch.float32).to(dtype)
        else:  # one slot's view of an 8-slot cache, as prefill passes it
            kc = torch.randn((slot_of, sk, h_kv, d), generator=g,
                             device="cuda", dtype=torch.float32).to(dtype)
            vc = torch.randn((slot_of, sk, h_kv, d), generator=g,
                             device="cuda", dtype=torch.float32).to(dtype)
            k, v = kc[3:4], vc[3:4]
        off = None if offsets is None else torch.tensor(
            offsets, dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=scale,
                                     q_offset=off)
        ro, rlse = flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=scale, q_offset=off)
        torch.cuda.synchronize()
        diff = (o.float() - ro.float()).abs()
        err = diff.max().item()
        err_lse = (lse - rlse).abs().max().item()
        # Per row (one head's D outputs of one query): a row that sees
        # one key has |o| near 4, a row that sees 2048 keys near 0.05, so
        # one scale for the tensor would let the long rows' errors pass.
        # bf16: kernel and plain version round p and o to bf16 from f32
        # values that differ only in summation order; allow 2 ulps of the
        # row's largest output, floored at 2**-4 so rows of near-zero
        # outputs are held to 2**-10 absolute. f32: summation order only.
        row_mag = ro.float().abs().amax(-1, keepdim=True).clamp_min(2 ** -4)
        tol_rel = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
        err_over_tol = (diff / (tol_rel * row_mag)).max().item()
        tol_lse = 1e-3  # f32 logsumexp over <= 2048 terms, order only
        finite = bool(torch.isfinite(o.float()).all()) \
            and bool(torch.isfinite(lse).all())
        offs = [0] * b if offsets is None else list(offsets)
        elt = q.element_size()
        keys = [min(sk, off_b + sq) if causal else sk for off_b in offs]
        nbytes = 2 * q.numel() * elt + lse.numel() * 4 \
            + sum(2 * kb * h_kv * d * elt for kb in keys)
        visible = sum(min(sk, off_b + i + 1) if causal else sk
                      for off_b in offs for i in range(sq))
        ops = 4 * h * d * visible
        dname = str(dtype).split(".")[-1]
        b_ms, b_by = bound(nbytes, ops, dname)

        kernel = time_ms.stats(lambda: flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=scale, q_offset=off))
        plain_ms = time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=scale, q_offset=off), iters=3)
        # The yardstick: SDPA in the form that lets PyTorch pick its
        # fastest backend. Offset 0 is exactly is_causal=True (top-left);
        # other offsets need an explicit boolean mask.
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                 scale=scale, enable_gqa=True)
        if causal and not any(offs):
            lib, form = functools.partial(sdpa, is_causal=True), \
                "is_causal=True"
        elif causal:
            rows = torch.tensor(offs, device="cuda")[:, None] \
                + torch.arange(sq, device="cuda")[None]
            mask = (torch.arange(sk, device="cuda")[None, None]
                    <= rows[:, :, None])[:, None]
            lib, form = functools.partial(sdpa, attn_mask=mask), \
                "attn_mask=bool [B, 1, Sq, Sk]"
        else:
            lib, form = sdpa, "no mask"
        lib_diff = (lib().transpose(1, 2).float() - ro.float()).abs()
        library = time_ms.stats(lib)
        row = {"phase": "kernels", "kernel": "flash_fwd", "case": label,
               "shape": {"b": b, "sq": sq, "sk": sk, "h": h, "h_kv": h_kv,
                         "d": d, "causal": causal, "q_offset": offsets,
                         "dtype": dname},
               "max_abs_err": err,
               "tol": f"{tol_rel} x max(2**-4, row's max |o|)",
               "max_err_over_tol": err_over_tol,
               "max_abs_err_lse": err_lse,
               "tol_lse": tol_lse, "kernel_ms": kernel["median"],
               "kernel_ms_stats": kernel,
               "tflop_per_s": ops / kernel["median"] / 1e9,
               "plain_ms": plain_ms, "library_ms": library["median"],
               "library_ms_stats": library,
               "library": f"scaled_dot_product_attention({form})",
               # SDPA's own distance from the plain version, in the same
               # per-row tolerance units (printed, not checked).
               "library_err_over_tol":
                   (lib_diff / (tol_rel * row_mag)).max().item(),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        check(finite and err_over_tol <= 1 and err_lse <= tol_lse,
              f"flash_fwd {label}: err {err} ({err_over_tol} x its row's "
              f"tol), lse err {err_lse} (tol {tol_lse}), finite {finite}")
        return row

    rows = []
    bf16 = torch.bfloat16
    for bucket in (1, 37, 512, 2048):
        for off in (0, 611):
            rows.append(case(f"prefill bucket {bucket} offset {off}", 1,
                             bucket, 2048, [off], True, bf16, slot_of=8))
    decode_offsets = [0, 5, 100, 511, 1000, 1500, 2046, 2047]
    rows.append(case("decode 8 slots", 8, 1, 2048, decode_offsets, True,
                     bf16))
    rows.append(case("train b4 s2048", 4, 2048, 2048, None, True, bf16))
    rows.append(case("non-causal ragged", 2, 512, 1000, None, False, bf16))
    rows.append(case("head_dim 128", 1, 512, 2048, [0], True, bf16, d=128))
    rows.append(case("float32", 1, 512, 2048, [0], True, torch.float32))
    # The tensor-core kernel's edges: one row past the 8-row tile, a row
    # and a key one past a 64-row tile with one head per group, a group
    # of 8, a short block at the end of a full cache, and head_dim 128
    # with an offset and without a mask.
    rows.append(case("Sq 9 offset 611", 1, 9, 2048, [611], True, bf16,
                     slot_of=8))
    rows.append(case("MHA h 8 h_kv 8 Sq=Sk=129", 1, 129, 129, None, True,
                     bf16, h=8, h_kv=8))
    rows.append(case("group of 8: h 32 h_kv 4", 1, 1024, 1024, None, True,
                     bf16, h_kv=4))
    rows.append(case("Sq 48 offset 2000 slot view", 1, 48, 2048, [2000],
                     True, bf16, slot_of=8))
    rows.append(case("head_dim 128 offset 611", 1, 512, 2048, [611], True,
                     bf16, d=128, slot_of=8))
    rows.append(case("head_dim 128 non-causal Sq 200 Sk 129", 1, 200, 129,
                     None, False, bf16, d=128))
    # A prefix-cache hit's tail prefill after a 1024-token head: a 4-token
    # tail on the 8-row tile (more than one row at an offset), a 300-token
    # tail's bucket on the tensor cores.
    for bucket in (4, 512):
        rows.append(case(f"prefix tail bucket {bucket} offset 1024", 1,
                         bucket, 2048, [1024], True, bf16, slot_of=8))
    return rows


def visible_keys(sq: int, sk: int, causal: bool) -> int:
    """(row, key) pairs the mask keeps: row i sees key j iff j < sk and,
    causal, j <= i (query offset 0)."""
    return sum(min(sk, i + 1) for i in range(sq)) if causal else sq * sk


def flash_bwd_checks(torch, seed, time_ms):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    def case(label, b, sq, sk, causal, dtype, d=64, h=32, h_kv=8):
        g = torch.Generator("cuda").manual_seed(seed + 7)

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = randn(b, sq, h, d), randn(b, sk, h_kv, d), \
            randn(b, sk, h_kv, d)
        do = randn(b, sq, h, d)
        scale = d ** -0.5
        o, lse = A.flash_attention_fwd(q, k, v, causal=causal,
                                       sm_scale=scale)
        got = A.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    sm_scale=scale)
        ref = A.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                              causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        # Per row (one head's D gradients of one query or one key), as
        # for the forward: kernel and plain version round p and ds to the
        # storage dtype and each output once, from f32 sums taken in
        # another order (and, for dk/dv, over the GQA group in another
        # order); bf16 may then differ by 2 ulps of the row's largest
        # value, floored at 2**-4. f32: summation order only.
        tol_rel = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
        err = {}
        for name, x, y in zip(("dq", "dk", "dv"), got, ref):
            diff = (x.float() - y.float()).abs()
            row_mag = y.float().abs().amax(-1, keepdim=True).clamp_min(
                2 ** -4)
            err[name] = (diff.max().item(),
                         (diff / (tol_rel * row_mag)).max().item(),
                         bool(torch.isfinite(x.float()).all()))

        tensors, scalars = A._bwd_launch_args(q, k, v, o, lse, do, causal,
                                              scale)
        dq_t = time_ms.stats(lambda: A._launch_bwd("dq", tensors, scalars))
        dkv_t = time_ms.stats(lambda: A._launch_bwd("dkv", tensors,
                                                    scalars))
        plain_ms = time_ms(lambda: A.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, sm_scale=scale), iters=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             scale=scale, enable_gqa=True)
        dot = do.transpose(1, 2)
        library = time_ms.stats(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))

        dname = str(dtype).split(".")[-1]
        elt = q.element_size()
        # Each input read once (q, do, k, v; lse and delta in f32), each
        # output written once; dq does three products of 2·d operations
        # per visible (row, key) pair, dk/dv four.
        pairs = b * h * visible_keys(sq, sk, causal)
        read = (2 * q.numel() + 2 * k.numel()) * elt + 2 * lse.numel() * 4
        ops = {"dq": 6 * d * pairs, "dkv": 8 * d * pairs}
        bounds = {"dq": bound(read + q.numel() * elt, ops["dq"], dname),
                  "dkv": bound(read + 2 * k.numel() * elt, ops["dkv"],
                               dname)}
        shape = {"b": b, "sq": sq, "sk": sk, "h": h, "h_kv": h_kv, "d": d,
                 "causal": causal, "dtype": dname}
        rows = []
        for kernel, names, stats in (("flash_bwd_dq", ("dq",), dq_t),
                                     ("flash_bwd_dkv", ("dk", "dv"), dkv_t)):
            ms = stats["median"]
            kind = kernel.rsplit("_", 1)[1]
            row = {"phase": "kernels", "kernel": kernel, "case": label,
                   "shape": shape,
                   "max_abs_err": max(err[n][0] for n in names),
                   "tol": f"{tol_rel} x max(2**-4, row's max |grad|)",
                   "max_err_over_tol": max(err[n][1] for n in names),
                   "kernel_ms": ms, "kernel_ms_stats": stats,
                   "tflop_per_s": ops[kind] / ms / 1e9,
                   "plain_ms": plain_ms,
                   "plain": "flash_attention_bwd_reference, dq dk dv "
                            "together",
                   "library_ms": library["median"],
                   "library_ms_stats": library,
                   "library": "autograd of scaled_dot_product_attention, "
                              "dq dk dv together",
                   "bound_ms": bounds[kind][0], "bound_by": bounds[kind][1]}
            emit(row)
            rows.append(row)
            for n in names:
                check(err[n][2] and err[n][1] <= 1,
                      f"{kernel} {label}: {n} err {err[n][0]} ({err[n][1]} "
                      f"x its row's tol), finite {err[n][2]}")
        return rows

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("train b4 s2048", 4, 2048, 2048, True, bf16),
             ("ragged Sq=Sk=1000", 1, 1000, 1000, True, bf16),
             ("non-causal Sq 300 Sk 517", 2, 300, 517, False, bf16),
             ("head_dim 128", 1, 512, 512, True, bf16, 128),
             ("float32", 1, 512, 512, True, f32),
             ("float32 head_dim 128 non-causal Sq 257 Sk 130", 1, 257, 130,
              False, f32, 128),
             # The tensor-core kernels' edges: one head per group, a group
             # of 8, a row and a key one past a 64-row tile (and, at
             # head_dim 128, past the 32-row q tile of dk/dv).
             ("MHA h 8 h_kv 8", 2, 512, 512, True, bf16, 64, 8, 8),
             ("group of 8: h 32 h_kv 4", 1, 1024, 1024, True, bf16, 64, 32,
              4),
             ("Sq=Sk=129", 1, 129, 129, True, bf16),
             ("head_dim 128 MHA Sq=Sk=129", 1, 129, 129, True, bf16, 128, 8,
              8),
             ("head_dim 128 non-causal Sq 200 Sk 129", 1, 200, 129, False,
              bf16, 128)]
    return [row for c in cases for row in case(*c)]


def rms_checks(torch, seed, time_ms):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for n in (8, 512, 2048, 8192):
            g = torch.Generator("cuda").manual_seed(seed + n)
            d = 2048
            x = torch.randn((n, d), generator=g, device="cuda").to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                 ).to(dtype)
            out = rms_norm(x, w, 1e-5)
            ref = rms_norm_reference(x, w, 1e-5)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            mag = ref.float().abs().max().item()
            # Both compute in f32 and round once; the sum of squares is
            # taken in another order, which can flip one bf16 rounding
            # (2**-8 relative): allow 2 ulps. f32: order only.
            tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * mag
            dname = str(dtype).split(".")[-1]
            nbytes = (2 * x.numel() + w.numel()) * x.element_size()
            b_ms, b_by = bound(nbytes, 4 * x.numel(), dname)

            def kernel():
                return rms_norm(x, w, 1e-5)

            def library():
                return F.rms_norm(x, (d,), w, 1e-5)

            kernel_t = time_ms.stats(kernel)
            library_t = time_ms.stats(library)
            row = {"phase": "kernels", "kernel": "rms_norm",
                   "case": f"rows {n}", "shape": {"rows": n, "d": d,
                                                  "dtype": dname},
                   "max_abs_err": err, "tol": tol,
                   "kernel_ms": kernel_t["median"],
                   "kernel_ms_stats": kernel_t,
                   "plain_ms": time_ms(lambda: rms_norm_reference(x, w,
                                                                  1e-5)),
                   "library_ms": library_t["median"],
                   "library_ms_stats": library_t,
                   "library": "torch.nn.functional.rms_norm",
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            check(bool(torch.isfinite(out.float()).all()) and err <= tol,
                  f"rms_norm rows {n} {dname}: err {err} (tol {tol})")
            rows.append(row)
    return rows


# -- serving helpers: launch counts, the prefix cache's host time ------------


PREFIX_METHODS = ("_prefix_copy_in", "_prefix_admit")


@contextlib.contextmanager
def timed_calls(cls, names):
    """While the block runs, record the host milliseconds of each call of
    the methods ``names`` of ``cls`` (for the engine's copies: the time
    to enqueue them, not the card's time to run them). Yields ``{name:
    [ms, ...]}``; the class's own methods are put back on exit, and no
    instance is touched."""
    spent = {name: [] for name in names}
    saved = {name: cls.__dict__[name] for name in names}
    for name in names:
        def timed(*args, _fn=saved[name], _out=spent[name], **kw):
            t = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                _out.append((time.perf_counter() - t) * 1e3)
        setattr(cls, name, timed)
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def host_summary(spent):
    return {name: {"calls": len(ms), "total_ms": sum(ms),
                   "max_ms": max(ms, default=0.0),
                   "median_ms": statistics.median(ms) if ms else 0.0}
            for name, ms in spent.items()}


def zero_counts():
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)
    from ray_tpu_torch.ops.norms import rms_norm

    flash_attention_fwd.launches = rms_norm.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0


def read_counts():
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)
    from ray_tpu_torch.ops.norms import rms_norm

    return {"flash_fwd": flash_attention_fwd.launches,
            "rms_norm": rms_norm.launches,
            "flash_bwd_dq": flash_attention_bwd.dq_launches,
            "flash_bwd_dkv": flash_attention_bwd.dkv_launches}


def check_launches(label, cfg, launches, m0, m1):
    """Each forward of the serving path launches the flash forward once
    per layer and rms_norm twice per layer and once at the end; nothing
    launches a backward kernel."""
    forwards = (m1["prefills"] - m0["prefills"]) \
        + (m1["decode_forwards"] - m0["decode_forwards"])
    expected = {"flash_fwd": cfg.n_layers * forwards,
                "rms_norm": (2 * cfg.n_layers + 1) * forwards,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    check(forwards > 0 and launches == expected,
          f"{label}: kernel launches {launches}, expected {expected} for "
          f"{forwards} forwards")
    return forwards


# -- phase 5: serving ---------------------------------------------------------


def device_profile(torch, fn, steps):
    """Where the time of ``fn`` (``steps`` steps of work) goes:
    torch.profiler over one call; device busy time is the sum of the
    kernels' own device time, the rest of the wall time the card sits
    idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # Device-side events only: the CPU-side operators carry their
        # kernels' time too and would count it twice.
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": (1 - busy_ms / wall_ms) if rows
            else "not measured",
            "kernel_launches_per_step": sum(r[2] for r in rows) / steps,
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "calls_per_step": n / steps}
                            for us, k, n in rows[:8]],
            "note": "profiler on: host times include its overhead"}


def decode_profile(torch, engine, last, ctx, temps, topks, reps=3):
    def blocks():
        for _ in range(reps):
            engine._decode_impl(last, ctx, temps, topks)

    return device_profile(torch, blocks, reps * engine.decode_steps)


def serve(torch, seed, smi):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm import (LLMDeployment, LLMEngine,
                                         SamplingParams)

    cfg = LlamaConfig.llama3_1b()
    slots, max_seq, max_tokens, n_req = 8, 2048, 32, 12
    t0 = time.perf_counter()
    dep = LLMDeployment(
        cfg, lambda: init_params(
            cfg, torch.Generator("cuda").manual_seed(seed), "cuda"),
        max_batch_size=slots, max_seq_len=max_seq, decode_steps=4,
        warmup_max_prompt_len=1024, device="cuda")
    setup_s = time.perf_counter() - t0
    engine = dep.engine
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 1001, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    results = [None] * n_req
    errors = []

    def run(i):
        try:
            if i == n_req - 1:  # sampled: temperature + top-k
                t = time.perf_counter()
                toks = engine.generate(prompts[i], SamplingParams(
                    max_tokens=max_tokens, temperature=0.8, top_k=40))
                results[i] = {"tokens": toks,
                              "latency_s": time.perf_counter() - t}
            else:
                results[i] = dep({"prompt_ids": prompts[i],
                                  "max_tokens": max_tokens})
        except Exception as e:  # reported below; the run then fails
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_req)]
    # The main path's run: kernel counts from 0 just before, read just
    # after.
    with timed_calls(LLMEngine, PREFIX_METHODS) as host_ms:
        zero_counts()
        m0 = engine.metrics()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = read_counts()
        m1 = engine.metrics()
    check(not any(t.is_alive() for t in threads), "requests hung")
    check(not errors, "; ".join(errors))
    for i, r in enumerate(results):
        toks = r["tokens"]
        check(len(toks) == max_tokens, f"request {i}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {i}: token outside the vocabulary")
    forwards = check_launches("serve", cfg, launches, m0, m1)
    engine.stop()

    # Decode step time: all 8 slots at 512 tokens of context.
    zeros = torch.zeros(slots, dtype=torch.int32, device="cuda")
    ctx = torch.full((slots,), 512, dtype=torch.int32, device="cuda")
    greedy = np.zeros(slots, np.float32)
    topk = np.zeros(slots, np.int32)
    engine._decode_impl(zeros, ctx, greedy, topk)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        engine._decode_impl(zeros, ctx, greedy, topk)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (reps * engine.decode_steps)
    profile = decode_profile(torch, engine, zeros, ctx, greedy, topk)

    ttfts = [r["ttft_s"] for r in results[:-1]]
    total = sum(len(r["tokens"]) for r in results)
    row = {"phase": "serve", "model": "llama3_1b", "layers": cfg.n_layers,
           "dim": cfg.dim, "slots": slots, "max_seq_len": max_seq,
           "decode_steps": engine.decode_steps, "requests": n_req,
           "prompt_lengths": [int(n) for n in lengths],
           "max_tokens": max_tokens, "setup_s": setup_s,
           "warmup_s": dep.warmup_s, "wall_s": wall,
           "tokens": total, "tokens_per_s": total / wall,
           "ttft_p50_s": statistics.median(ttfts),
           "decode_step_ms_8_slots_ctx_512": step_ms,
           "decode_profile": profile,
           "forwards": forwards, "launches": launches,
           "launches_per_forward": {"flash_fwd": cfg.n_layers,
                                    "rms_norm": 2 * cfg.n_layers + 1},
           "kv_cache": m1["kv_cache"],
           "prefix_host_ms": host_summary(host_ms),
           "card": smi}
    emit(row)
    del dep, engine
    torch.cuda.empty_cache()
    return row


# -- phase 6: the prefix cache ------------------------------------------------


PREFIX_HEAD = 1024        # the shared head: 64 blocks of 16 tokens
PREFIX_SMALL_BYTES = 48 << 20   # 96 blocks of 512 KiB: the head + 32

# A copy-in plus the tail's prefill is held to two references, both
# bf16 on the card:
# - The same kernels without the cache: the primer (whose admission
#   stored the head's blocks) prefilled whole in another slot, which
#   must give the stored bits again, then the same tail from the same
#   offset. Same kernels, same inputs: the logits must be equal bit for
#   bit, so the cache adds no error at all.
# - A full prefill of the whole prompt. Its tail rows run in a 2048-row
#   bucket, so other kernels compute them (a tail of <= 8 rows runs the
#   8-row attention tile at its offset, a full prompt the tensor-core
#   tile), which sum in another order and may round a few activations
#   the other way. The random-weight model spreads any one such flip
#   across the logits. The run measures that spread (`nudge`: one element
#   of the first token's embedding one bf16 ulp larger, the full prefill
#   again) and allows PREFIX_NUDGES times it.
# Planted faults show that the checks can fail: a stale row (block 1's
# payload replaced by block 0's) and a wrong start (the tail prefilled
# one block early) must each break the bit-exact check and exceed the
# limit. (A copy-in with its blocks rotated would not: the head's K/V
# carry their positions' rotary phases, and attention over a permuted set
# of keys is the same sum. The transport check catches that one.)
PREFIX_NUDGES = 2


def prefix_prompts(cfg, seed):
    """The shared-head traffic of ``benchmarks/llm_bench.py`` at full
    width: one 1024-token head; the primer and four others end in
    4-token tails, as there; seven end in seeded tails of 40-300 tokens
    (a chat turn)."""
    rng = np.random.default_rng(seed + 5)
    head = rng.integers(0, cfg.vocab_size, PREFIX_HEAD).tolist()
    tails = [4] * 5 + [int(n) for n in rng.integers(40, 301, 7)]
    return [head + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in tails]


def prefix_leg(torch, cfg, params, prompts, max_tokens, **cache):
    """A fresh engine: the primer alone, then the other requests at once.
    Returns the row, the tokens of each request and the stopped engine."""
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams

    engine = LLMEngine(cfg, params, max_batch_size=8, max_seq_len=2048,
                       decode_steps=4, device="cuda", **cache)
    # Every bucket up to 2048: the primer (1028 tokens) and, with the
    # cache off, every prompt prefill at 2048.
    engine.warmup()
    results = [None] * len(prompts)
    errors = []

    def run(i):
        try:
            t = time.perf_counter()
            it = engine.generate(prompts[i], SamplingParams(
                max_tokens=max_tokens), stream=True)
            toks = [next(it)]
            ttft = time.perf_counter() - t
            toks += list(it)
            results[i] = {"tokens": toks, "ttft_s": ttft,
                          "latency_s": time.perf_counter() - t}
        except Exception as e:  # reported below; the run then fails
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(1, len(prompts))]
    with timed_calls(LLMEngine, PREFIX_METHODS) as host_ms:
        zero_counts()
        m0 = engine.metrics()
        run(0)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = read_counts()
        m1 = engine.metrics()
    engine.stop()
    check(not any(t.is_alive() for t in threads), "prefix: requests hung")
    check(not errors, "; ".join(errors))
    for i, r in enumerate(results):
        check(len(r["tokens"]) == max_tokens
              and all(0 <= t < cfg.vocab_size for t in r["tokens"]),
              f"prefix: request {i}: tokens {r['tokens']}")
    forwards = check_launches("prefix", cfg, launches, m0, m1)
    ttfts = [r["ttft_s"] for r in results[1:]]
    pc = engine.prefix_cache
    row = {"prefix_cache_bytes": pc and pc.capacity_bytes,
           "wall_s": wall,
           "tokens_per_s": sum(len(r["tokens"]) for r in results[1:]) / wall,
           "ttft_p50_s": statistics.median(ttfts),
           "ttft_s": ttfts, "primer_ttft_s": results[0]["ttft_s"],
           "forwards": forwards, "launches": launches,
           "kv_cache": m1.get("kv_cache"),
           "host_ms": host_summary(host_ms)}
    return row, [r["tokens"] for r in results], engine


def copy_in_check(torch, engine, primer, prompt):
    """On a stopped engine whose cache holds the primer's head: copy the
    cached head of ``prompt`` into slot 0 and prefill its tail there.
    The slot's head must equal the stored payloads bit for bit, and the
    last position's logits must equal those of the same tail prefilled
    after the primer without the cache (slot 1) bit for bit, and those of
    a full prefill of ``prompt`` (slot 2) within ``PREFIX_NUDGES`` times
    the model's spread of one rounding flip (slot 2 again). Planted
    faults run in slot 3."""
    import types

    bt = engine.block_tokens
    m_tok, chain = engine._prefix_copy_in(types.SimpleNamespace(
        job="check"), 0, prompt)
    held = engine.prefix_cache.lookup(chain[:m_tok // bt])
    rows = [engine._kv_store[h.block_id] for h in held]
    engine.prefix_cache.release(held)
    payload = engine._kv_arena[rows].to("cuda")  # [m, 2, L, bt, Hkv, D]

    def head_is_payload(slot):
        same = len(rows) == m_tok // bt
        for j, name in enumerate(("k", "v")):
            region = engine.cache[name][:, slot, :m_tok]
            want = payload[:, j].transpose(0, 1).flatten(1, 2)
            same = same and torch.equal(region.view(torch.int16),
                                        want.view(torch.int16))
        return same

    def prefill(tokens, slot, start):
        padded = torch.zeros((1, engine._serve_bucket(len(tokens))),
                             dtype=torch.long)
        padded[0, :len(tokens)] = torch.tensor(tokens)
        return engine._prefill(padded.to("cuda"), slot, len(tokens),
                               start).float()

    tail = prompt[m_tok:]
    transport = head_is_payload(0)
    got = prefill(tail, 0, m_tok)
    prefill(primer, 1, 0)
    reproduced = head_is_payload(1)
    same = prefill(tail, 1, m_tok)
    full = prefill(prompt, 2, 0)
    # The model's own spread of one flip.
    embed = engine.params["embed"]
    row0, kept = prompt[0], embed[prompt[0], 0].clone()
    embed[row0, 0] = (kept.float() * (1 + 2 ** -7)).to(embed.dtype)
    try:
        nudged = prefill(prompt, 2, 0)
    finally:
        embed[row0, 0] = kept
    nudge = (nudged - full).abs().max().item()
    nudge_rms = (nudged - full).square().mean().sqrt().item()
    limit = PREFIX_NUDGES * nudge
    err = (got - full).abs().max().item()

    def over_limit(e):
        return e / limit if limit else math.inf if e else 0.0

    def planted(fault_rows, start):
        engine._copy_blocks_in(3, fault_rows)
        bad = prefill(tail, 3, start)
        e = (bad - full).abs().max().item()
        return {"bit_equal": bool(torch.equal(bad, same)),
                "max_abs_err": e, "over_limit": over_limit(e),
                "rms_err_over_nudge_rms":
                    (bad - full).square().mean().sqrt().item() / nudge_rms}

    std = full.std().item()
    return {"tail": len(tail), "matched": m_tok,
            "transport_bit_exact": bool(transport),
            "head_reproduced_without_cache": bool(reproduced),
            "same_kernels_bit_exact": bool(torch.equal(got, same)),
            "max_abs_err": err, "ref_std": std,
            "max_err_over_std": err / std,
            "nudge_max_abs_err": nudge,
            "nudge_max_err_over_std": nudge / std,
            "nudge_rms": nudge_rms,
            "rms_err_over_nudge_rms":
                (got - full).square().mean().sqrt().item() / nudge_rms,
            "limit": limit, "max_err_over_limit": over_limit(err),
            "argmax_equal": bool(got.argmax() == full.argmax()),
            "planted": {"stale row": planted(rows[:1] + rows[:1] + rows[2:],
                                             m_tok),
                        "wrong start": planted(rows, m_tok - bt)}}


def divergence(torch, engine, prompt, off, on):
    """Where greedy tokens with the cache on first differ from those with
    it off: the position, and the cache-off top-2 logit margin there and
    the logits' spread (a full prefill of the prompt and the cache-off
    tokens before it)."""
    j = next(i for i, (a, b) in enumerate(zip(off, on)) if a != b)
    seq = prompt + off[:j]
    padded = torch.zeros((1, engine._serve_bucket(len(seq))),
                         dtype=torch.long)
    padded[0, :len(seq)] = torch.tensor(seq)
    logits = engine._prefill(padded.to("cuda"), 2, len(seq)).float()
    top = logits.topk(2)
    return {"position": j, "off": off[j], "on": on[j],
            "margin": (top.values[0] - top.values[1]).item(),
            "std": logits.std().item()}


def prefix(torch, seed, smi, time_ms):
    """Three legs on fresh engines over the same shared-head traffic: the
    cache off, on, and on with room for 96 blocks, so that blocks are
    evicted. Checks hits, evictions, launches, transport, logits and
    greedy tokens; prints TTFT, tokens/s and the cache's host ms."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_1b()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                         "cuda")
    prompts = prefix_prompts(cfg, seed)
    max_tokens, n_later = 32, len(prompts) - 1
    head_blocks = PREFIX_HEAD // 16
    legs, tokens, launches, checks = {}, {}, {}, {}
    timings = run_prefix_legs(torch, cfg, params, prompts, max_tokens, seed,
                              time_ms, legs, tokens, launches, checks)
    row = {"phase": "prefix", "model": "llama3_1b", "layers": cfg.n_layers,
           "slots": 8, "max_seq_len": 2048, "decode_steps": 4,
           "head_tokens": PREFIX_HEAD,
           "tails": [len(p) - PREFIX_HEAD for p in prompts],
           "max_tokens": max_tokens,
           "traffic": "the primer alone, then the other 11 at once",
           "legs": legs, "copy_in": checks, "card_ms": timings,
           "tol": f"copy-in + tail against the same tail without the "
                  f"cache: bit for bit; against a full prefill: "
                  f"{PREFIX_NUDGES} x the max |logit change| of one bf16 "
                  f"ulp in one embedding element (nudge)",
           "host_ms": "perf_counter around each call of the engine's "
                      "_prefix_copy_in and _prefix_admit: enqueueing "
                      "their copies, not the card's time",
           "card": smi}
    emit(row)
    for label, c in checks.items():
        check(c["matched"] == PREFIX_HEAD and c["transport_bit_exact"]
              and c["head_reproduced_without_cache"]
              and c["same_kernels_bit_exact"],
              f"prefix, copy-in {label}: {c}")
        check(c["max_err_over_limit"] <= 1 and c["argmax_equal"],
              f"prefix, copy-in {label}: logits against a full prefill: "
              f"{c}")
        for fault, f in c["planted"].items():
            check(not f["bit_equal"],
                  f"prefix, copy-in {label}: the planted fault "
                  f"'{fault}' passes the checks: {f}")
    # A divergence is allowed only where the cache-off top-2 margin is
    # under what the two logits may each move by: the limit above, as a
    # share of the logits' spread, at the larger of the runs' nudges.
    per_std = PREFIX_NUDGES * max(c["nudge_max_err_over_std"]
                                  for c in checks.values())
    for name in ("on", "small"):
        stats = legs[name]["kv_cache"]
        check(stats["hits"] >= n_later * head_blocks,
              f"prefix, {name}: {stats['hits']} hits, expected at least "
              f"{n_later} x {head_blocks}")
        for i, d in legs[name]["diverged"].items():
            check(d["margin"] < 2 * per_std * d["std"],
                  f"prefix, {name}: request {i} diverges from the cache-off "
                  f"tokens at a top-2 margin over 2 x {per_std} x std: {d}")
    check(legs["small"]["kv_cache"]["evictions"] > 0,
          f"prefix, small: no eviction: {legs['small']['kv_cache']}")
    return {k: sum(launches[leg][k] for leg in launches)
            for k in launches["off"]}


def run_prefix_legs(torch, cfg, params, prompts, max_tokens, seed, time_ms,
                    legs, tokens, launches, checks):
    """The three legs of the prefix phase, filling the dicts given;
    returns the cache-on engine's ``prefix_card_ms``."""
    for name, cache in (("off", {"prefix_cache": False}), ("on", {}),
                        ("small", {"prefix_cache_bytes":
                                   PREFIX_SMALL_BYTES})):
        row, tokens[name], engine = prefix_leg(torch, cfg, params, prompts,
                                               max_tokens, **cache)
        legs[name] = row
        launches[name] = row["launches"]
        if name == "on":
            # Fresh tails after the head, so that only the head matches:
            # the 8-row tile (4 tokens) and the tensor-core tile (300),
            # each at offset 1024.
            rng = np.random.default_rng(seed + 7)
            checks.update({f"tail {n}": copy_in_check(
                torch, engine, prompts[0], prompts[0][:PREFIX_HEAD]
                + rng.integers(0, cfg.vocab_size, n).tolist())
                for n in (4, 300)})
            timings = prefix_card_ms(torch, engine, prompts[0], time_ms)
        diverged = {}
        if name != "off":
            for i, (a, b) in enumerate(zip(tokens["off"], tokens[name])):
                if a != b:
                    diverged[i] = divergence(torch, engine, prompts[i], a, b)
            row["diverged"] = diverged
        del engine
        torch.cuda.empty_cache()
    return timings


def prefix_card_ms(torch, engine, primer, time_ms):
    """What an admission costs the card with a hit and without one, on a
    stopped engine whose cache holds the primer. The 64-block copy-in and
    the readback of 64 blocks (into the rows they came from: the same
    bytes) are timed with CUDA events (L2 cold, the mean of 3). A prefill
    is hundreds of launches, which the host enqueues more slowly than the
    card runs them, so events would time the host: each prefill (a 4- and
    a 300-token tail at offset 1024, a 2048-token bucket) is read by the
    profiler instead, as its wall time and the card's busy time."""
    from ray_tpu_torch._private.kv_cache import chain_keys

    held = engine.prefix_cache.lookup(chain_keys(
        primer[:PREFIX_HEAD], engine.block_tokens, engine._chain_seed))
    rows = [engine._kv_store[h.block_id] for h in held]
    engine.prefix_cache.release(held)

    def tokens(seq, bucket):
        t = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        t[0, :len(seq)] = torch.tensor(seq)
        return t

    def prefill_ms(*args):
        engine._prefill(*args)
        p = device_profile(torch, lambda: engine._prefill(*args), 1)
        return {"wall_ms": p["wall_ms_per_step"],
                "busy_ms": p["device_busy_ms_per_step"]}

    engine._copy_blocks_in(4, rows)
    nbytes = len(rows) * engine._block_nbytes
    copy_in = time_ms(lambda: engine._copy_blocks_in(3, rows), iters=3)
    readback = time_ms(lambda: engine._read_blocks(
        4, list(range(len(rows))), rows), iters=3)
    return {"copy_in_64_blocks_ms": copy_in,
            "copy_in_gb_per_s": nbytes / copy_in / 1e6,
            "readback_64_blocks_ms": readback,
            "readback_gb_per_s": nbytes / readback / 1e6,
            "prefill_tail_4_offset_1024": prefill_ms(
                tokens(primer[-4:], 4), 3, 4, PREFIX_HEAD),
            "prefill_tail_300_offset_1024": prefill_ms(
                tokens(primer[-4:] * 75, 512), 3, 300, PREFIX_HEAD),
            "prefill_bucket_2048": prefill_ms(
                tokens(primer, 2048), 5, len(primer))}


# -- phase 7: two models on one engine ----------------------------------------


def models(torch, seed, smi):
    """One LLMDeployment holding two Llama-3.2-1B weight sets (seeds
    ``seed`` and ``seed + 1``): 6 requests alternate between them one at
    a time, then one prompt goes to "a" and then to "b". Each reply must
    equal a one-model deployment's of the same weights, "b" must get no
    hit from "a"'s blocks, and each alternation must swap once."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

    cfg = LlamaConfig.llama3_1b()

    def loader(s):
        return lambda: init_params(
            cfg, torch.Generator("cuda").manual_seed(s), "cuda")

    kw = dict(max_batch_size=8, max_seq_len=2048, decode_steps=4,
              warmup_max_prompt_len=1024, device="cuda")
    dep = LLMDeployment(cfg, models={"a": loader(seed),
                                     "b": loader(seed + 1)}, **kw)
    rng = np.random.default_rng(seed + 6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 700, 6)]
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    sequence = [(p, "ab"[i % 2]) for i, p in enumerate(prompts)] \
        + [(shared, "a"), (shared, "b")]
    max_tokens, replies = 32, []
    with timed_calls(LLMDeployment, ("_ensure_model",)) as ensure_ms, \
            timed_calls(LLMEngine, ("swap_params",)) as swap_calls:
        zero_counts()
        m0 = dep.engine.metrics()
        for i, (p, name) in enumerate(sequence):
            if i == len(sequence) - 1:
                kv0 = dep.engine.metrics()["kv_cache"]
            replies.append(dep({"prompt_ids": p, "max_tokens": max_tokens,
                                "model": name})["tokens"])
        launches = read_counts()
        m1 = dep.engine.metrics()
    dep.engine.stop()
    swaps = len(swap_calls["swap_params"])
    # The host ms of each request's _ensure_model that swapped: drain,
    # then swap_params.
    swap_ms, live = [], dep.default_model
    for (_, name), ms in zip(sequence, ensure_ms["_ensure_model"]):
        if name != live:
            swap_ms.append(ms)
            live = name
    forwards = check_launches("models", cfg, launches, m0, m1)
    kv1 = m1["kv_cache"]
    cross = {"hits": kv1["hits"] - kv0["hits"],
             "misses": kv1["misses"] - kv0["misses"]}
    weights = {name: dep._load_model(name) for name in ("a", "b")}
    del dep
    torch.cuda.empty_cache()
    alone = [None] * len(sequence)
    for name in ("a", "b"):
        # Tokens only, nothing timed: no warmup.
        one = LLMDeployment(cfg, lambda: weights[name], warmup=False, **kw)
        for i, (p, n) in enumerate(sequence):
            if n == name:
                alone[i] = one({"prompt_ids": p,
                                "max_tokens": max_tokens})["tokens"]
        one.engine.stop()
        del one
        torch.cuda.empty_cache()
    alternations = sum(a[1] != b[1] for a, b in zip(sequence, sequence[1:]))
    row = {"phase": "models", "model": "llama3_1b x 2 (seeds "
           f"{seed}, {seed + 1})", "layers": cfg.n_layers,
           "sequence": [n for _, n in sequence],
           "prompt_lengths": [len(p) for p, _ in sequence],
           "max_tokens": max_tokens, "swaps": swaps,
           "alternations": alternations, "swap_ms": swap_ms,
           "swap": "drain, then the weights' pointers: both sets stay on "
                   "the card", "forwards": forwards, "launches": launches,
           "same_prompt_b_after_a": cross,
           "identical_to_one_model": [r == a for r, a in zip(replies,
                                                             alone)],
           "card": smi}
    emit(row)
    check(swaps == alternations,
          f"models: {swaps} swaps for {alternations} alternations")
    check(cross == {"hits": 0, "misses": len(shared) // 16},
          f"models: model b's lookups of a's prompt: {cross}")
    for i, (r, a) in enumerate(zip(replies, alone)):
        check(r == a, f"models: request {i} ({sequence[i][1]}) differs "
                      f"from its one-model deployment: {r} != {a}")
    return launches


# -- phase 8: end-to-end logits against the CPU -------------------------------


def to_cpu(tree):
    """A parameter tree as f32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.float().cpu()


def logits_check(torch, seed):
    from ray_tpu_torch.models.llama import (LlamaConfig, forward_with_cache,
                                            init_kv_cache, init_params)

    cfg = dataclasses.replace(LlamaConfig.llama3_1b(), n_layers=2)
    cfg_cpu = dataclasses.replace(cfg, dtype=torch.float32,
                                  attention="flash")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed + 1),
                         "cuda")
    params_cpu = to_cpu(params)
    rng = np.random.default_rng(seed + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, 44))
    n_prompt = 40

    def run(p, c, device):
        cache = init_kv_cache(c, 1, 128, device=device)
        outs = []
        logits, _ = forward_with_cache(
            p, toks[None, :n_prompt].to(device), c, cache,
            torch.zeros(1, dtype=torch.int32, device=device))
        outs.append(logits[0].float().cpu())
        for i in range(n_prompt, len(toks)):
            logits, _ = forward_with_cache(
                p, toks[None, i:i + 1].to(device), c, cache,
                torch.full((1,), i, dtype=torch.int32, device=device))
            outs.append(logits[0].float().cpu())
        return torch.cat(outs)

    got = run(params, cfg, "cuda")
    ref = run(params_cpu, cfg_cpu, "cpu")
    diff = (got - ref).abs()
    err = diff.max().item()
    std = ref.std().item()
    # bf16 activations and logits on the card against f32 on the CPU,
    # same bf16 weights. Per logit: 2**-7 of its size (its own bf16
    # rounding is 2**-9; the largest logit, the input token's own through
    # the tied embedding, is ~30x the rest) plus a tenth of the logits'
    # spread for the hidden state's bf16 error (a few roundings of
    # 2**-9 each, summed over 2048 products). Attention that is wrong but
    # finite moves the residual stream, and so the logits, by a good part
    # of their spread.
    tol = 2 ** -7 * ref.abs() + 0.1 * std
    err_over_tol = (diff / tol).max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    row = {"phase": "logits", "model": "llama3_1b cut to 2 layers",
           "steps": "prefill 40 + decode 4", "shape": list(got.shape),
           "max_abs_err": err, "max_abs_ref": ref.abs().max().item(),
           "ref_std": std, "tol": "2**-7 x |logit| + 0.1 x std(logits)",
           "max_err_over_tol": err_over_tol, "argmax_agreement": agree,
           "min_argmax_agreement": 0.9}
    emit(row)
    check(bool(torch.isfinite(got).all()) and err_over_tol <= 1
          and agree >= 0.9,
          f"end-to-end logits: err {err} ({err_over_tol} x tol), argmax "
          f"agreement {agree}")
    return row


# -- phase 9: gradients against the CPU ---------------------------------------


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


# remat="gate" against remat=False, both on the card: the same bf16 ops
# on the same inputs (the recompute reruns them as they ran), so each
# leaf's relative error stays far below one bf16 rounding (2**-9).
REMAT_GRAD_LIMIT = 1e-6

# Relative error ||g_card - g_cpu|| / ||g_cpu|| allowed for each leaf of
# the 2-layer 1B model. The card runs bf16 activations, weights and
# gradients; the CPU f32 on the same bf16 weight values, so each leaf
# carries a few bf16 roundings (2**-9 each) through two layers. Each
# limit is about twice the first H100 run's reading for that leaf
# (0.0019 for the norms' weights up to 0.0100 for wq; see PERF.md).
GRAD_LIMITS = {
    "/embed": 0.0125, "/final_norm": 0.005,
    "/layers/attn_norm": 0.01, "/layers/wq": 0.02, "/layers/wk": 0.02,
    "/layers/wv": 0.0125, "/layers/wo": 0.0125, "/layers/mlp_norm": 0.005,
    "/layers/w1": 0.016, "/layers/w3": 0.016, "/layers/w2": 0.016,
}


def grads_check(torch, seed):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)

    cfg = dataclasses.replace(LlamaConfig.llama3_1b(), n_layers=2,
                              remat=False)
    # The CPU side runs the flash kernels' plain versions ("auto" would
    # take the plain attention there), as the card runs the kernels.
    cfg_cpu = dataclasses.replace(cfg, dtype=torch.float32,
                                  attention="flash")
    cfg_remat = dataclasses.replace(cfg, remat="gate")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed + 2),
                         "cuda")
    params_cpu = to_cpu(params)
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}

    def grads(p, c, device):
        named = named_leaves(p)
        for _, t in named:
            t.requires_grad_()
        loss, _ = loss_fn(p, {k: v.to(device) for k, v in batch.items()}, c)
        gs = torch.autograd.grad(loss, [t for _, t in named])
        for _, t in named:
            t.requires_grad_(False)
        return loss.item(), {n: g.float().cpu()
                             for (n, _), g in zip(named, gs)}

    def compare(got, ref, limits):
        leaves = {}
        for name, r in ref.items():
            g = got[name]
            rel = ((g - r).norm() / r.norm()).item()
            cos = (torch.dot(g.flatten().double(), r.flatten().double())
                   / (g.double().norm() * r.double().norm())).item()
            leaves[name] = {"rel_err": rel, "limit": limits.get(name),
                            "cosine": cos,
                            "finite": bool(torch.isfinite(g).all())}
        return leaves

    dq0 = flash_attention_bwd.dq_launches
    loss, got = grads(params, cfg, "cuda")
    dq_launches = flash_attention_bwd.dq_launches - dq0
    fwd0, dq0 = flash_attention_fwd.launches, flash_attention_bwd.dq_launches
    loss_remat, got_remat = grads(params, cfg_remat, "cuda")
    remat_launches = {"flash_fwd": flash_attention_fwd.launches - fwd0,
                      "flash_bwd_dq": flash_attention_bwd.dq_launches - dq0}
    loss_ref, ref = grads(params_cpu, cfg_cpu, "cpu")
    leaves = compare(got, ref, GRAD_LIMITS)
    remat_leaves = compare(got_remat, got,
                           dict.fromkeys(GRAD_LIMITS, REMAT_GRAD_LIMIT))
    row = {"phase": "grads", "model": "llama3_1b cut to 2 layers",
           "batch": [2, 256], "loss": loss, "loss_cpu": loss_ref,
           "dq_launches": dq_launches,
           "check": "per leaf ||g - g_cpu|| / ||g_cpu|| <= limit "
                    "(cosine printed, not checked)",
           "leaves": leaves,
           "remat_gate": {
               "check": f"per leaf ||g_gate - g|| / ||g|| <= "
                        f"{REMAT_GRAD_LIMIT}, both on the card",
               "loss": loss_remat, "launches": remat_launches,
               "leaves": remat_leaves}}
    emit(row)
    check(set(leaves) == set(GRAD_LIMITS), f"leaves {sorted(leaves)}")
    check(dq_launches == cfg.n_layers,
          f"grads: {dq_launches} dq launches for {cfg.n_layers} layers")
    check(remat_launches == {"flash_fwd": cfg.n_layers,
                             "flash_bwd_dq": cfg.n_layers},
          f"grads, remat='gate': launches {remat_launches} for "
          f"{cfg.n_layers} layers")
    check(abs(loss - loss_ref) <= 1e-2 * abs(loss_ref),
          f"grads: loss {loss} on the card, {loss_ref} on the CPU")
    check(abs(loss_remat - loss) <= REMAT_GRAD_LIMIT * abs(loss),
          f"grads: loss {loss_remat} with remat='gate', {loss} without")
    for label, rows in (("", leaves), (", remat='gate'", remat_leaves)):
        bad = [n for n, v in rows.items()
               if not (v["finite"] and v["rel_err"] <= v["limit"])]
        check(not bad, f"grads{label}: leaves over their limits: "
                       f"{ {n: rows[n] for n in bad} }")
    return row


# -- phase 10: training -------------------------------------------------------


TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def train_setup(torch, cfg, seed):
    """bench.py's optimizer (make_optimizer(3e-4, warmup_steps=0, bf16
    moments)), random weights from ``seed`` with their optimizer state,
    and one random batch of TRAIN_BATCH x TRAIN_SEQ tokens, on the card.
    Returns ``(tx, state, batch)``."""
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.models.training import (init_train_state,
                                               make_optimizer)

    tx = make_optimizer(3e-4, warmup_steps=0, moment_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                         "cuda")
    state = init_train_state(params, tx)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               seed))
    return tx, state, {"tokens": tokens,
                       "targets": torch.roll(tokens, -1, dims=1)}


def train(torch, seed, smi):
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn
    from ray_tpu_torch.models.training import make_train_step
    from ray_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_fwd)
    from ray_tpu_torch.ops.norms import rms_norm

    # bench.py's configuration: remat="gate", batch 4 x 2048, bf16 moments.
    cfg = dataclasses.replace(LlamaConfig.llama3_1b(), remat="gate")
    batch_size, seq, steps = TRAIN_BATCH, TRAIN_SEQ, 3
    t0 = time.perf_counter()
    tx, state, batch = train_setup(torch, cfg, seed + 3)
    step = make_train_step(lambda p, b: loss_fn(p, b, cfg), tx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def counts():
        return {"flash_fwd": flash_attention_fwd.launches,
                "flash_bwd_dq": flash_attention_bwd.dq_launches,
                "flash_bwd_dkv": flash_attention_bwd.dkv_launches,
                "rms_norm": rms_norm.launches}

    # The main path's run: kernel counts from 0 just before, read just
    # after.
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = rms_norm.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    records = []
    for i in range(steps):
        c0 = counts()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        c1 = counts()
        records.append({"step": i, "ms": ms, "loss": metrics["loss"].item(),
                        "grad_norm": metrics["grad_norm"].item(),
                        "launches": {k: c1[k] - c0[k] for k in c1}})
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The flash forward is saved across each layer's checkpoint, so it
    # runs once per layer. rms_norm runs twice per layer and once at the
    # end in the forward, and the backward's recompute of each layer
    # reruns both of its norms (it stops after the last saved value,
    # which comes after mlp_norm): 4 L + 1.
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers,
                "rms_norm": 4 * cfg.n_layers + 1}
    profile = device_profile(torch, lambda: step(state, batch), 1)
    steady_ms = statistics.mean(r["ms"] for r in records[1:])
    losses = [r["loss"] for r in records]
    row = {"phase": "train", "model": "llama3_1b", "layers": cfg.n_layers,
           "dim": cfg.dim, "batch": batch_size, "seq": seq,
           "remat": cfg.remat, "fused_ce": cfg.fused_ce,
           "optimizer": "make_optimizer(3e-4, warmup_steps=0, "
                        "moment_dtype=bfloat16)",
           "setup_s": setup_s, "steps": records,
           "step_ms_steady": steady_ms,
           "tokens_per_s": batch_size * seq / steady_ms * 1e3,
           "peak_memory_gb": peak_gb, "launches": launches,
           "launches_per_step": per_step, "step_profile": profile,
           "card": smi}
    emit(row)
    for r in records:
        check(r["launches"] == per_step,
              f"train step {r['step']}: launches {r['launches']}, "
              f"expected {per_step}")
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"train step {r['step']}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
    check(losses[-1] < losses[0],
          f"train: loss did not fall over {steps} steps: {losses}")
    del state, batch
    torch.cuda.empty_cache()
    return row


# -- phase 11: peak memory under each remat mode against the plan -------------


# The host's time per step is read at this many tokens (batch 1): the
# same ops and launches as at TRAIN_BATCH x TRAIN_SEQ (the fused CE
# blocks the vocabulary, not the tokens), but so little work for the card
# that it waits on the host, and the wall time is the host's.
HOST_SEQ = 128


def memory(torch, seed, smi):
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn
    from ray_tpu_torch.models.memory_plan import plan_llama
    from ray_tpu_torch.models.training import make_train_step

    base = LlamaConfig.llama3_1b()
    tx, state, batch = train_setup(torch, base, seed + 4)
    small = {k: v[:1, :HOST_SEQ].contiguous() for k, v in batch.items()}
    modes = {}
    leaves = [t for _, t in named_leaves(state.params)]
    for remat in (False, True, "gate", "mlp"):
        cfg = dataclasses.replace(base, remat=remat)
        step = make_train_step(lambda p, b, cfg=cfg: loss_fn(p, b, cfg), tx)
        # Forward and backward alone (what the checkpoint changes), then
        # two whole steps (the update too), each from a fresh peak.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for t in leaves:
            t.requires_grad_(True)
        grads = torch.autograd.grad(loss_fn(state.params, batch, cfg)[0],
                                    leaves)
        for t in leaves:
            t.requires_grad_(False)
        del grads
        peak_fwd_bwd = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        profile = device_profile(torch, lambda: step(state, batch), 1)
        # The host's time: one step to warm up, the mean of three, then a
        # profiled one for the card's share of that wall time.
        state, _ = step(state, small)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, small)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        host_profile = device_profile(torch, lambda: step(state, small), 1)
        plan = plan_llama(cfg, {"data": 1}, batch_per_chip=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, moment_dtype_bytes=2,
                          remat=remat)
        plan_bytes = plan["per_chip_gib"]["total"] * (1 << 30)
        modes[str(remat)] = {"peak_fwd_bwd_gb": peak_fwd_bwd / 1e9,
                             "plan_gb": plan_bytes / 1e9,
                             "ratio": peak_fwd_bwd / plan_bytes,
                             "peak_step_gb": peak / 1e9,
                             "plan_gib": plan["per_chip_gib"],
                             "step_ms": step_ms,
                             "device_busy_ms": profile[
                                 "device_busy_ms_per_step"],
                             "host_ms": host_ms,
                             "host_step_device_busy_ms": host_profile[
                                 "device_busy_ms_per_step"],
                             "host_step_launches": host_profile[
                                 "kernel_launches_per_step"],
                             "loss": metrics["loss"].item()}
    row = {"phase": "memory", "model": "llama3_1b", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "moments": "bfloat16",
           "peak_fwd_bwd": "torch.cuda.max_memory_allocated over loss_fn "
                           "and its gradient alone, from "
                           "reset_peak_memory_stats; ratio is it over the "
                           "plan",
           "peak_step": "the same over two whole steps from their own "
                        "reset (the update too, which the plan does not "
                        "count)",
           "step_ms": "the second step, host clock between synchronizes",
           "device_busy_ms": "a third step under torch.profiler: the sum "
                             "of its kernels' device time",
           "host_ms": f"mean of three steps at batch 1 x {HOST_SEQ} "
                      "tokens, host clock between synchronizes; "
                      "host_step_device_busy_ms is the card's work in one "
                      "such step (profiler)",
           "plan": "ray_tpu_torch.models.memory_plan.plan_llama, "
                   "{'data': 1}, moment_dtype_bytes=2",
           "device_total_gb":
               torch.cuda.get_device_properties(0).total_memory / 1e9,
           "modes": modes, "card": smi}
    emit(row)
    peaks = {k: v["peak_fwd_bwd_gb"] for k, v in modes.items()}
    for k, v in modes.items():
        check(math.isfinite(v["loss"]),
              f"memory, remat={k}: loss {v['loss']}")
        check(0.8 <= v["ratio"] <= 1.25,
              f"memory, remat={k}: forward and backward peak "
              f"{v['peak_fwd_bwd_gb']} GB is {v['ratio']} x the plan's "
              f"{v['plan_gb']} GB (allowed 0.8-1.25)")
    check(peaks["False"] > peaks["mlp"] > peaks["gate"] > peaks["True"],
          f"memory: expected forward and backward peaks False > mlp > "
          f"gate > True, got {peaks}")
    steps = {k: v["peak_step_gb"] for k, v in modes.items()}
    check(max(steps[k] for k in ("True", "gate", "mlp")) < steps["False"],
          f"memory: a checkpointing mode's whole step peaks at or above "
          f"remat=False's: {steps}")
    del state, batch, small
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": per_kernel, "sources": sorted(_build.sources())})

    seconds = {}

    def phase(name, fn, *extra):
        t = time.perf_counter()
        out = fn(torch, args.seed, *extra)
        seconds[name] = time.perf_counter() - t
        return out

    kernel_resources(_build)
    time_ms = make_timer(torch)
    flash_rows = phase("kernels: flash_fwd", flash_checks, time_ms)
    bwd_rows = phase("kernels: flash_bwd", flash_bwd_checks, time_ms)
    rms_rows = phase("kernels: rms_norm", rms_checks, time_ms)
    served = phase("serve", serve, smi)
    prefixed = phase("prefix", prefix, smi, time_ms)
    multiplexed = phase("models", models, smi)
    phase("logits", logits_check)
    phase("grads", grads_check)
    trained = phase("train", train, smi)
    phase("memory", memory, smi)
    emit({"phase": "seconds", "seconds": seconds})

    def entry(name, source, replaces, row, *others):
        by_path = {"serve": served["launches"][name],
                   "prefix": prefixed[name], "models": multiplexed[name],
                   "train": trained["launches"][name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "case": row["case"],
                "other_cases": {o["case"]: {k: o[k] for k in (
                    "ms", "bound_ms", "library_ms")} for o in (
                    dict(r, ms=r["kernel_ms"]) for r in others)}}

    def fwd_row(label):
        return next(r for r in flash_rows if r["case"] == label)

    rms8 = rms_rows[0]  # bf16, 8 rows: the decode step's shape
    rms8192 = rms_rows[3]  # bf16, 8192 rows: the train step's shape
    dq, dkv = (next(r for r in bwd_rows if r["kernel"] == k
                    and r["case"] == "train b4 s2048")
               for k in ("flash_bwd_dq", "flash_bwd_dkv"))
    kernels = [
        # The train step's shape, on the tensor-core kernel; decode (the
        # 8-row kernel), a 2048-token prefill and a prefix hit's 4-token
        # tail beside it.
        entry("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
              "ray_tpu/ops/attention.py:56", fwd_row("train b4 s2048"),
              fwd_row("decode 8 slots"),
              fwd_row("prefill bucket 2048 offset 0"),
              fwd_row("prefix tail bucket 4 offset 1024")),
        entry("rms_norm", "ray_tpu_torch/csrc/rms_norm.cu",
              "ray_tpu/ops/norms.py:44", rms8, rms8192),
        entry("flash_bwd_dq", "ray_tpu_torch/csrc/flash_bwd.cu",
              "ray_tpu/ops/attention.py:330", dq),
        entry("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_bwd.cu",
              "ray_tpu/ops/attention.py:237", dkv)]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
