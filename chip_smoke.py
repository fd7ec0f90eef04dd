#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, each printing one JSON line:

1. device  — the card's name, count and power limit (nvidia-smi).
2. build   — compiles every kernel under ray_tpu_torch/csrc/ (one nvcc
             per source, all at once) and prints the build seconds.
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving path's shapes, with the stated
             tolerance, and times kernel, plain version and one PyTorch
             library call (yardstick only) beside the least time the card
             could take (bound).
4. serve   — LLMDeployment on Llama-3.2-1B (full width and depth, random
             weights from --seed), answering concurrent requests; checks
             every answer and that the main path launched each kernel
             the expected number of times; prints tokens/s, TTFT p50 and
             the decode step time.
5. logits  — one prompt's prefill and 4 decode steps of the 1B model cut
             to 2 layers, on the card (bf16, kernels) against the CPU
             (f32, plain versions).

Then the kernels line and, last, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before the last line; with no CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time

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


def make_timer(torch):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn, iters: int = 10) -> float:
        """Mean device time of ``fn`` over ``iters`` runs, each with a
        cold L2 (a 128 MiB write between runs), from CUDA events."""
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    return time_ms


# -- phase 3: kernels against their plain versions ---------------------------


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

        kernel_ms = time_ms(lambda: flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=scale, q_offset=off))
        plain_ms = time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=scale, q_offset=off), iters=3)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = None
        if causal:
            rows = torch.tensor(offs, device="cuda")[:, None] \
                + torch.arange(sq, device="cuda")[None]
            mask = (torch.arange(sk, device="cuda")[None, None]
                    <= rows[:, :, None])[:, None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
        row = {"phase": "kernels", "kernel": "flash_fwd", "case": label,
               "shape": {"b": b, "sq": sq, "sk": sk, "h": h, "h_kv": h_kv,
                         "d": d, "causal": causal, "q_offset": offsets,
                         "dtype": dname},
               "max_abs_err": err,
               "tol": f"{tol_rel} x max(2**-4, row's max |o|)",
               "max_err_over_tol": err_over_tol,
               "max_abs_err_lse": err_lse,
               "tol_lse": tol_lse, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "scaled_dot_product_attention",
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
    rows.append(case("non-causal ragged", 2, 512, 1000, None, False, bf16))
    rows.append(case("head_dim 128", 1, 512, 2048, [0], True, bf16, d=128))
    rows.append(case("float32", 1, 512, 2048, [0], True, torch.float32))
    return rows


def rms_checks(torch, seed, time_ms):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for n in (8, 512, 2048):
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
            row = {"phase": "kernels", "kernel": "rms_norm",
                   "case": f"rows {n}", "shape": {"rows": n, "d": d,
                                                  "dtype": dname},
                   "max_abs_err": err, "tol": tol,
                   "kernel_ms": time_ms(lambda: rms_norm(x, w, 1e-5)),
                   "plain_ms": time_ms(lambda: rms_norm_reference(x, w,
                                                                  1e-5)),
                   "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w,
                                                            1e-5)),
                   "library": "torch.nn.functional.rms_norm",
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            check(bool(torch.isfinite(out.float()).all()) and err <= tol,
                  f"rms_norm rows {n} {dname}: err {err} (tol {tol})")
            rows.append(row)
    return rows


# -- phase 4: serving ---------------------------------------------------------


def decode_profile(torch, engine, last, ctx, temps, topks, reps=3):
    """Where a decode block's time goes: torch.profiler over ``reps``
    blocks; device busy time is the sum of the kernels' own device time,
    the rest of the wall time the card sits idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._decode_impl(last, ctx, temps, topks)
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
    steps = reps * engine.decode_steps
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": (1 - busy_ms / wall_ms) if rows
            else "not measured",
            "kernel_launches_per_step": sum(r[2] for r in rows) / steps,
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "calls_per_step": n / steps}
                            for us, k, n in rows[:8]],
            "note": "profiler on: host times include its overhead"}


def serve(torch, seed, smi):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops.attention import flash_attention_fwd
    from ray_tpu_torch.ops.norms import rms_norm
    from ray_tpu_torch.serve.llm import LLMDeployment, SamplingParams

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
    flash_attention_fwd.launches = 0
    rms_norm.launches = 0
    m0 = engine.metrics()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "rms_norm": rms_norm.launches}
    m1 = engine.metrics()
    check(not any(t.is_alive() for t in threads), "requests hung")
    check(not errors, "; ".join(errors))
    forwards = (m1["prefills"] - m0["prefills"]) \
        + (m1["decode_forwards"] - m0["decode_forwards"])
    for i, r in enumerate(results):
        toks = r["tokens"]
        check(len(toks) == max_tokens, f"request {i}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {i}: token outside the vocabulary")
    expected = {"flash_fwd": cfg.n_layers * forwards,
                "rms_norm": (2 * cfg.n_layers + 1) * forwards}
    check(launches == expected,
          f"kernel launches {launches}, expected {expected} for "
          f"{forwards} forwards")
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
           "card": smi}
    emit(row)
    del dep, engine
    torch.cuda.empty_cache()
    return row


# -- phase 5: end-to-end logits against the CPU -------------------------------


def logits_check(torch, seed):
    from ray_tpu_torch.models.llama import (LlamaConfig, forward_with_cache,
                                            init_kv_cache, init_params)

    cfg = dataclasses.replace(LlamaConfig.llama3_1b(), n_layers=2)
    cfg_cpu = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed + 1),
                         "cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.float().cpu()

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

    time_ms = make_timer(torch)
    flash_rows = flash_checks(torch, args.seed, time_ms)
    rms_rows = rms_checks(torch, args.seed, time_ms)
    served = serve(torch, args.seed, smi)
    logits_check(torch, args.seed)

    def entry(name, source, replaces, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": served["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "case": row["case"]}

    decode = next(r for r in flash_rows if r["case"] == "decode 8 slots")
    rms8 = rms_rows[0]  # bf16, 8 rows: the decode step's shape
    print(smi, flush=True)
    emit({"kernels": [
        entry("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
              "ray_tpu/ops/attention.py:56", decode),
        entry("rms_norm", "ray_tpu_torch/csrc/rms_norm.cu",
              "ray_tpu/ops/norms.py:44", rms8)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
