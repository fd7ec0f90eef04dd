"""Continuous-batching LLM engine on PyTorch and CUDA.

Counterpart of ``ray_tpu/serve/llm.py``, for one model on one card:

- The KV cache is slot-based: ``max_batch_size`` sequence slots, each with
  a ``max_seq_len`` KV region (``models.llama.init_kv_cache``). Admission
  = prefill into a free slot; retirement frees the slot. A decode step
  runs over all slots whatever their occupancy.
- Prefill lengths are bucketed to powers of two; a bucket's padding
  tokens write KV past the prompt, which decode overwrites before any
  query attends to it (the absolute-position mask hides the rest).
- Sampling (greedy / temperature / top-k) runs on the device with the
  engine's ``torch.Generator``; one admission wave samples its first
  tokens in one batched call and one host sync.
- Decode is multi-step (``decode_steps`` tokens per dispatch) and
  pipelined: block N+1 is launched before block N's tokens are read on
  the host, and those tokens come back through an asynchronous copy, so
  the host's bookkeeping overlaps the card's compute.

The engine is thread-safe: callers enqueue requests and block on their
completion (or stream tokens); a background loop interleaves admission
and decode.

Prefix/KV cache (on by default, as in the JAX engine): the full
``kv_block_tokens``-sized chunks of every admitted prompt are
hash-chained into the :class:`~ray_tpu_torch._private.kv_cache.PrefixCache`
decision core, and their KV is read back into a host arena (pinned
memory on CUDA, made once) after the admission wave's first tokens, so
TTFT never pays for it. A later request that shares the prompt head
copies the matched blocks into its slot and prefills ONLY the tail, at
the tail's bucket, from the matched offset. Every copy runs on the engine's one
stream, ordered after the wave's prefills and any decode block still
writing into a retired slot. Chain keys are seeded with the model's
name, so two models never cross-hit.

Multi-model: ``LLMDeployment(models={...})`` holds N weight sets for one
engine; a request for another model drains the engine and swaps the
weights (:meth:`LLMEngine.swap_params`), under a cold-start deadline.

Not yet ported: the prefix cache's shm warm tier (it waits for the
object plane; an evicted payload is dropped, as the JAX engine does with
no plane), ``prefix_digests`` and cache-affinity routing, critical-path
stages and ``perf_stats`` counters (they come with the serve runtime:
proxy, router, controller).
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import _build
from ray_tpu_torch._private.kv_cache import PrefixCache, chain_keys
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    forward_with_cache,
    init_kv_cache,
    resolve_device,
)


class PromptTooLongError(ValueError):
    """Prompt exceeds the engine's slot KV region (``max_seq_len - 1``
    tokens: one position must remain for generation). Raised at
    ``generate()``."""

    def __init__(self, n_tokens: int, cap: int):
        super().__init__(
            f"prompt of {n_tokens} tokens exceeds the engine's "
            f"{cap}-token cap (max_seq_len {cap + 1}); truncate or "
            f"shard client-side")
        self.n_tokens = n_tokens
        self.cap = cap


class UnknownModelError(ValueError):
    """The request names a model this deployment does not hold."""

    def __init__(self, model: str, known):
        super().__init__(
            f"unknown model {model!r}; this replica serves {known}")
        self.model = model
        self.known = list(known)


class ModelSwapDeadlineError(RuntimeError):
    """A weight swap took longer than the deployment's
    ``model_swap_deadline_s``. The loaded weights STAY cached, so an
    immediate retry is warm: the deadline is a latency contract, not a
    capability failure."""

    def __init__(self, model: str, took_s: float, deadline_s: float):
        super().__init__(
            f"swap to model {model!r} took {took_s:.2f}s, over the "
            f"{deadline_s:.2f}s cold-start deadline (retry is warm)")
        self.model = model
        self.took_s = took_s
        self.deadline_s = deadline_s


# Per-slot top_k values are clamped to this (one sorted prefix of this
# width serves every slot).
_TOP_K_MAX = 64


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0            # 0 = full softmax; clamped to _TOP_K_MAX
    stop_token_ids: tuple = ()


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt: List[int]
    params: SamplingParams
    out_queue: "queue.Queue"
    tokens: List[int] = dataclasses.field(default_factory=list)
    model: Optional[str] = None
    priority: int = 1     # 0 interactive > 1 normal > 2 batch
    job: str = "default"  # the tenant charged for the prompt's KV blocks


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    def __init__(self, cfg: LlamaConfig, params, *,
                 max_batch_size: int = 8, max_seq_len: Optional[int] = None,
                 decode_steps: int = 1, seed: int = 0,
                 model: str = "default", prefix_cache: bool = True,
                 kv_block_tokens: int = 16,
                 prefix_cache_bytes: int = 256 << 20, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _params_to(params, self.device)
        self.model = model
        self.n_slots = max_batch_size
        # Tokens generated per decode dispatch. >1 trades admission
        # granularity (a new request waits for the current block) for
        # K-fold fewer host round trips.
        self.decode_steps = max(1, int(decode_steps))
        self.max_seq = max_seq_len or cfg.max_seq_len
        self.cache = init_kv_cache(cfg, self.n_slots, self.max_seq,
                                   device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        # Per-slot host state.
        self._free_slots = list(range(self.n_slots))
        self._slot_req: Dict[int, _Request] = {}
        self._lengths = np.zeros(self.n_slots, np.int32)  # tokens in cache
        self._last_token = np.zeros(self.n_slots, np.int32)
        self._active = np.zeros(self.n_slots, bool)
        self._temps_arr = np.zeros(self.n_slots, np.float32)
        self._topks_arr = np.zeros(self.n_slots, np.int32)

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # Requests accepted by generate() and not yet retired: a weight
        # swap needs 0 (a request drained from the queue but not yet in
        # a slot is neither queued nor active).
        self._unfinished = 0
        self._req_counter = itertools.count()
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Pipelined decode: the in-flight block's (host tokens, copy-done
        # event), plus device-side last-token/length carries valid while
        # no admission has touched the host copies.
        self._pending = None
        self._dev_last: Optional[torch.Tensor] = None
        self._dev_lengths: Optional[torch.Tensor] = None
        # Model forwards run, for callers that check kernel launch counts.
        self._n_prefills = 0
        self._n_decode_forwards = 0

        # Prefix/KV cache: the PrefixCache decision core decides which
        # blocks exist, are pinned or get evicted; their payloads live in
        # a host arena made once (pinned on CUDA, so that no copy pays
        # for pinning memory), one row [2 (k, v), L, block_tokens, Hkv,
        # D] per block the capacity holds. _kv_store maps each resident
        # block's generation id to its row: an evicted block's row is
        # freed and its payload dropped.
        self.block_tokens = max(1, int(kv_block_tokens))
        k = self.cache["k"]
        per_token = 2 * k.numel() * k.element_size() \
            // (k.shape[1] * k.shape[2])
        self._block_nbytes = per_token * self.block_tokens
        self.prefix_cache: Optional[PrefixCache] = None
        self._kv_store: Dict[int, int] = {}
        if prefix_cache and self.block_tokens < self.max_seq:
            self.prefix_cache = PrefixCache(prefix_cache_bytes,
                                            self.block_tokens)
            rows = int(prefix_cache_bytes) // self._block_nbytes
            self._kv_arena = torch.empty(
                (rows, 2, k.shape[0], self.block_tokens) + k.shape[3:],
                dtype=k.dtype, pin_memory=self.device.type == "cuda")
            self._free_rows = list(range(rows - 1, -1, -1))
        self._chain_seed = self._seed_for(model)

    def _seed_for(self, model: str) -> str:
        """Chain-key seed: model identity + the KV-shape fingerprint, the
        JAX engine's string. Two chains share keys only when the cached
        bytes are interchangeable: same model, same layout."""
        c = self.cfg
        return (f"{model}|{c.n_layers}x{c.dim}x{c.n_kv_heads}x"
                f"{c.max_seq_len}|{self.block_tokens}")

    def warmup(self, max_prompt_len: Optional[int] = None) -> float:
        """Build the kernels and run every serving shape once before the
        first request: prefill at each power-of-two bucket up to
        ``max_prompt_len`` (default ``max_seq_len``), the admission
        sampler and one decode block. Must run before :meth:`start`.
        Returns the wall seconds spent. Warmup writes KV into slot 0;
        every slot's length stays 0, so all still read as empty."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("warmup() must run before the engine loop "
                               "starts")
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all()
        limit = min(max_prompt_len or self.max_seq, self.max_seq)
        buckets, b = [], 1
        while b < limit:
            buckets.append(b)
            b *= 2
        buckets.append(min(b, self.max_seq))
        last = None
        for bucket in sorted(set(buckets)):
            tokens = torch.zeros((1, bucket), dtype=torch.long,
                                 device=self.device)
            last = self._prefill(tokens, 0, 1)
        self._sample_admitted(last[None], np.zeros(1, np.float32))
        zeros = torch.zeros(self.n_slots, dtype=torch.int32,
                            device=self.device)
        toks, _, _ = self._decode_impl(zeros, zeros, self._temps_arr,
                                       self._topks_arr)
        toks.cpu()
        return time.perf_counter() - t0

    # -- device work -----------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, slot: int, length: int,
                 start: int = 0) -> torch.Tensor:
        """tokens: ``[1, bucket]`` padded prompt tail; writes the slot's KV
        from absolute position ``start`` (0 for a full prefill; the
        matched prefix's length when cached blocks were copied in ahead
        of this call) and returns the logits at the last real position
        ``[vocab]``."""
        slot_cache = {"k": self.cache["k"][:, slot:slot + 1],
                      "v": self.cache["v"][:, slot:slot + 1]}
        start_pos = torch.full((1,), start, dtype=torch.int32,
                               device=self.device)
        logits, _ = forward_with_cache(self.params, tokens, self.cfg,
                                       slot_cache, start_pos)
        self._n_prefills += 1
        return logits[0, length - 1]

    def _sample_admitted(self, logits: torch.Tensor,
                         temps: np.ndarray) -> torch.Tensor:
        """logits ``[n, vocab]``, temps ``[n]`` (host) → first token per
        row, greedy at temperature 0 (no top-k, as in the JAX engine)."""
        logits = logits.float()
        firsts = logits.argmax(-1)
        if (temps > 0).any():
            t = torch.from_numpy(temps).to(self.device)
            probs = torch.softmax(logits / t.clamp_min(1e-6)[:, None], -1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            firsts = torch.where(t > 0, sampled, firsts)
        return firsts

    def _decode_impl(self, last_tokens: torch.Tensor, lengths: torch.Tensor,
                     temps: np.ndarray, topks: np.ndarray):
        """``decode_steps`` tokens for every slot. last_tokens/lengths are
        int32 ``[slots]`` on the device; temps/topks are host arrays (all
        greedy skips the sampler). Returns (tokens ``[slots, K]``, last
        tokens, lengths), all on the device."""
        sampling = bool((temps > 0).any())
        if sampling:
            t = torch.from_numpy(temps.copy()).to(self.device)
            k = torch.from_numpy(topks.copy()).to(self.device)
            width = min(_TOP_K_MAX, self.cfg.vocab_size)
        tokens, out = last_tokens, []
        for _ in range(self.decode_steps):
            # Clamp for retired slots that keep computing until their slot
            # is re-admitted (pipelined decode reads lag a block): their
            # writes stay inside the slot instead of running off its end.
            lengths = lengths.clamp(max=self.max_seq - 2)
            logits, _ = forward_with_cache(self.params, tokens[:, None],
                                           self.cfg, self.cache, lengths)
            self._n_decode_forwards += 1
            logits = logits[:, 0, :].float()  # [slots, vocab]
            nxt = logits.argmax(-1)
            if sampling:
                # Per-slot top-k: threshold at each slot's k-th largest.
                kth = logits.topk(width, dim=-1).values
                idx = (k - 1).clamp(0, width - 1).long()
                thresh = kth.gather(1, idx[:, None])
                truncated = logits.masked_fill(logits < thresh,
                                               float("-inf"))
                sample_logits = torch.where((k > 0)[:, None], truncated,
                                            logits)
                probs = torch.softmax(
                    sample_logits / t.clamp_min(1e-6)[:, None], -1)
                sampled = torch.multinomial(probs, 1,
                                            generator=self._gen)[:, 0]
                nxt = torch.where(t > 0, sampled, nxt)
            tokens = nxt.to(torch.int32)
            lengths = lengths + 1
            out.append(tokens)
        return torch.stack(out, dim=1), tokens, lengths

    def _start_fetch(self, toks: torch.Tensor):
        """Start copying a decode block's tokens to the host."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finish_fetch(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()

    # -- public API ------------------------------------------------------

    def start(self):
        # Under the lock: concurrent generate() callers must never spawn
        # two engine loops.
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._running.set()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="llm-engine")
                self._thread.start()

    def running(self) -> bool:
        """Whether the engine loop is alive, i.e. admits and retires."""
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self):
        self._running.clear()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=10)

    def generate(self, prompt_ids: List[int],
                 params: Optional[SamplingParams] = None,
                 stream: bool = False, *,
                 model: Optional[str] = None,
                 priority: int = 1,
                 job: str = "default"):
        """Blocking generate (or an iterator of tokens with stream=True).
        ``model``, when given, must name the engine's live weight set
        (:class:`LLMDeployment` swaps weight sets); another name raises
        :class:`UnknownModelError`. ``job`` is the tenant that the
        prompt's cached KV blocks are charged to
        (:meth:`PrefixCache.charges`)."""
        prompt = [int(t) for t in prompt_ids]
        cap = self.max_seq - 1
        if len(prompt) > cap:
            raise PromptTooLongError(len(prompt), cap)
        if not prompt:
            raise ValueError("empty prompt")
        bad = [t for t in prompt if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids {bad[:5]} outside the vocabulary "
                             f"[0, {self.cfg.vocab_size})")
        req = _Request(
            request_id=next(self._req_counter), prompt=prompt,
            params=params or SamplingParams(), out_queue=queue.Queue(),
            model=model, priority=max(0, min(2, int(priority))), job=job)
        with self._lock:
            # Checked with the count under one lock: swap_params cannot
            # change the weights between this check and the admission.
            if model is not None and model != self.model:
                raise UnknownModelError(model, [self.model])
            self._unfinished += 1
        self._queue.put(req)
        self.start()

        def token_iter():
            while True:
                item = req.out_queue.get()
                if item is None:
                    return
                yield item

        if stream:
            return token_iter()
        return list(token_iter())

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "active_slots": int(self._active.sum()),
                "free_slots": len(self._free_slots),
                "queued": self._queue.qsize(),
                "unfinished": self._unfinished,
                "model": self.model,
                "prefills": self._n_prefills,
                "decode_forwards": self._n_decode_forwards,
            }
        if self.prefix_cache is not None:
            out["kv_cache"] = self.prefix_cache.stats()
        return out

    # -- engine loop -----------------------------------------------------

    def _loop(self):
        while self._running.is_set():
            admitted = self._admit()
            if not self._active.any():
                # Drop any in-flight block for fully-retired slots.
                self._flush_pending()
                if not admitted:
                    try:
                        req = self._queue.get(timeout=0.05)
                        self._queue.put(req)
                    except queue.Empty:
                        continue
                continue
            self._decode_once()

    def _serve_bucket(self, t_real: int) -> int:
        """Smallest power of two that holds ``t_real`` tokens, capped at
        the slot length."""
        b = 1
        while b < t_real:
            b *= 2
        return min(b, self.max_seq)

    def _admit(self) -> bool:
        if self._queue.empty() or not self._free_slots:
            return False
        # Admission invalidates the device carries and needs free slots:
        # drain the in-flight decode block first.
        self._flush_pending()
        drained: List[_Request] = []
        while True:
            try:
                drained.append(self._queue.get_nowait())
            except queue.Empty:
                break
        # Interactive (0) outranks normal (1) outranks batch (2); FIFO
        # within a class via the monotonic request id.
        drained.sort(key=lambda r: (r.priority, r.request_id))
        staged = []  # (req, slot, t_real, last_logits, chain)
        leftover: List[_Request] = []
        for req in drained:
            if not self._free_slots:
                leftover.append(req)
                continue
            slot = self._free_slots.pop()
            t_real = len(req.prompt)
            # Prefix-cache fast path: copy the matched KV blocks into the
            # slot, then prefill ONLY the tail, at the tail's bucket, from
            # the matched offset.
            m_tok, chain = self._prefix_copy_in(req, slot, req.prompt)
            tail = req.prompt[m_tok:]
            bucket = self._serve_bucket(len(tail))
            tokens = torch.zeros((1, bucket), dtype=torch.long)
            tokens[0, :len(tail)] = torch.tensor(tail)
            last = self._prefill(tokens.to(self.device), slot, len(tail),
                                 m_tok)
            staged.append((req, slot, t_real, last, chain))
        for req in leftover:
            self._queue.put(req)
        if not staged:
            return False
        # ONE batched sampling call and ONE host sync for the whole wave.
        temps = np.array([s[0].params.temperature for s in staged],
                         np.float32)
        firsts = self._sample_admitted(
            torch.stack([s[3] for s in staged]), temps).cpu().numpy()
        for (req, slot, t_real, _, _), first in zip(staged, firsts):
            first = int(first)
            req.tokens.append(first)
            req.out_queue.put(first)
            with self._lock:
                self._slot_req[slot] = req
                self._lengths[slot] = t_real
                self._last_token[slot] = first
                self._active[slot] = True
                self._temps_arr[slot] = req.params.temperature
                self._topks_arr[slot] = max(0, min(req.params.top_k,
                                                   _TOP_K_MAX))
                if self._finished(req, first):
                    self._retire(slot)
        # Prefix-cache read-back AFTER the wave's first tokens, so TTFT
        # does not pay for it. A slot retired above is re-admitted only by
        # a LATER _admit call, whose copies the stream orders after these
        # reads: the bytes read are this request's prefill output.
        for req, slot, _, _, chain in staged:
            self._prefix_admit(req, slot, chain)
        # Host state changed: rebuild device carries on the next decode.
        self._dev_last = self._dev_lengths = None
        return True

    def _decode_once(self):
        # The fed token occupies absolute position `lengths` (prompt is
        # 0..len-1, the first generated token sits at len, etc.). Launch
        # block N+1 from the device-side carries, THEN wait for block N's
        # tokens: the host's wait and bookkeeping overlap N+1's compute.
        last = self._dev_last if self._dev_last is not None \
            else torch.tensor(self._last_token, device=self.device)
        lengths = self._dev_lengths if self._dev_lengths is not None \
            else torch.tensor(self._lengths, device=self.device)
        toks, self._dev_last, self._dev_lengths = self._decode_impl(
            last, lengths, self._temps_arr, self._topks_arr)
        prev, self._pending = self._pending, self._start_fetch(toks)
        if prev is not None:
            self._consume_block(self._finish_fetch(prev))

    def _flush_pending(self):
        prev, self._pending = self._pending, None
        if prev is not None:
            self._consume_block(self._finish_fetch(prev))

    def _consume_block(self, next_host: np.ndarray):
        with self._lock:
            for slot in np.nonzero(self._active)[0]:
                req = self._slot_req[slot]
                # Walk this slot's K-token block; once the request
                # finishes mid-block the remaining tokens are padding
                # compute and are discarded.
                for k in range(next_host.shape[1]):
                    tok = int(next_host[slot, k])
                    req.tokens.append(tok)
                    req.out_queue.put(tok)
                    self._lengths[slot] += 1
                    self._last_token[slot] = tok
                    if self._finished(req, tok) or \
                            self._lengths[slot] >= self.max_seq - 1:
                        self._retire(slot)
                        break

    def _finished(self, req: _Request, token: int) -> bool:
        if token in req.params.stop_token_ids:
            return True
        return len(req.tokens) >= req.params.max_tokens

    def _retire(self, slot: int):
        """Free ``slot`` and end its request's stream. Caller holds
        ``_lock``."""
        req = self._slot_req.pop(slot, None)
        if req is not None:
            self._unfinished -= 1
            req.out_queue.put(None)
        self._active[slot] = False
        self._lengths[slot] = 0
        self._free_slots.append(slot)

    # -- prefix/KV cache ------------------------------------------------
    #
    # A chain key commits to the model seed and every token of the
    # prefix, so a key hit is byte-identical KV by construction (same
    # weights, same tokens, causal attention).

    def _prefix_copy_in(self, req: _Request, slot: int, prompt):
        """Copy the longest cached prefix of ``prompt`` into ``slot``'s KV
        region. Returns (matched tokens, chain keys)."""
        pc = self.prefix_cache
        if pc is None:
            return 0, []
        chain = chain_keys(prompt, self.block_tokens, self._chain_seed)
        if not chain:
            return 0, []
        hit = pc.lookup(chain, req.job)
        # Cap the match: (a) at least one real token goes through prefill
        # (its last-position logits give the first token), and (b) the
        # matched offset plus the tail's bucket fits the slot: the write
        # of an overhanging bucket is clamped back (forward_with_cache)
        # and would overwrite the copied prefix.
        bt = self.block_tokens
        m = min(len(hit), (len(prompt) - 1) // bt)
        while m > 0 and m * bt + self._serve_bucket(len(prompt) - m * bt) \
                > self.max_seq:
            m -= 1
        while len(hit) > m:
            pc.release([hit.pop()])
        if hit:
            self._copy_blocks_in(slot, [self._kv_store[h.block_id]
                                        for h in hit])
        pc.release(hit)
        return m * bt, chain

    def _copy_blocks_in(self, slot: int, rows: List[int]):
        """Write the arena rows of blocks 0..m-1 into ``slot``: one copy
        to the device per run of consecutive rows, then one strided copy
        each for k and v."""
        m, bt = len(rows), self.block_tokens
        stage = torch.empty((m,) + self._kv_arena.shape[1:],
                            dtype=self._kv_arena.dtype, device=self.device)
        for i, row, n in _runs(rows):
            stage[i:i + n].copy_(self._kv_arena[row:row + n],
                                 non_blocking=True)
        for j, name in enumerate(("k", "v")):
            dst = self.cache[name][:, slot, :m * bt].unflatten(1, (m, bt))
            dst.copy_(stage[:, j].transpose(0, 1))

    def _read_blocks(self, slot: int, indices: List[int], rows: List[int]):
        """Copy the KV of blocks ``indices`` of ``slot`` to arena ``rows``:
        one gather on the device, then one asynchronous copy to the host
        per run of consecutive rows."""
        bt = self.block_tokens
        kv = torch.stack([self.cache[name][:, slot, i * bt:(i + 1) * bt]
                          for i in indices for name in ("k", "v")])
        kv = kv.unflatten(0, (len(indices), 2))
        for i, row, n in _runs(rows):
            self._kv_arena[row:row + n].copy_(kv[i:i + n],
                                              non_blocking=True)

    def _prefix_admit(self, req: _Request, slot: int, chain):
        """After prefill, admit the prompt's full-block chain and read the
        KV of the newly created blocks back to the host arena. An evicted
        block's row is reused at once: a copy-in that still reads it was
        enqueued before this copy writes it, on the same stream."""
        pc = self.prefix_cache
        if pc is None or not chain:
            return
        created, evicted = pc.admit(chain, req.job, self._block_nbytes)
        for e in evicted:
            self._free_rows.append(self._kv_store.pop(e.block_id))
        if created:
            rows = sorted(self._free_rows.pop() for _ in created)
            self._read_blocks(slot, [h.index for h in created], rows)
            for h, row in zip(created, rows):
                self._kv_store[h.block_id] = row
        pc.release(created)

    # -- multi-model ----------------------------------------------------

    def swap_params(self, params, model: str):
        """Swap the served weight set (multi-model serving): the
        parameters move to the engine's device and the chain seed follows
        the model. The caller must have drained the engine: in-flight KV
        belongs to the OLD model."""
        with self._lock:
            if self._unfinished:
                raise RuntimeError(
                    "swap_params on a non-idle engine: drain first")
            self.params = _params_to(params, self.device)
            self.model = model
            self._chain_seed = self._seed_for(model)


def _runs(rows: List[int]):
    """``(position in rows, first row, count)`` of each run of
    consecutive ``rows``."""
    start = 0
    for i in range(1, len(rows) + 1):
        if i == len(rows) or rows[i] != rows[i - 1] + 1:
            yield start, rows[start], i - start
            start = i


# -- Serve integration ------------------------------------------------------


# Priority classes understood on the wire (ints 0-2 also accepted).
_PRIORITY_CLASSES = {
    "high": 0, "interactive": 0, "normal": 1, "low": 2, "batch": 2,
}


def _parse_priority(raw) -> int:
    if isinstance(raw, str):
        return _PRIORITY_CLASSES.get(raw.lower().strip(), 1)
    try:
        return max(0, min(2, int(raw)))
    except (TypeError, ValueError):
        return 1


class LLMDeployment:
    """Deployment-ready wrapper around one :class:`LLMEngine`: build it,
    warm it up, start its loop, then call it with a request dict (the
    contract of ``ray_tpu.serve.llm.LLMDeployment``): ``{"prompt_ids":
    [...], "max_tokens", "temperature", "stop_token_ids", "model",
    "priority", "job" (or "job_id"), "stream"}``.

    The engine may multiplex N weight sets (``models={name: params or a
    loader}``; ``params_fn`` alone is one model, ``"default"``). A request
    for another model than the engine's drains the engine, then swaps the
    weights (:meth:`LLMEngine.swap_params`); loaded weights stay cached,
    so a swap back is a move to the device at most. A swap slower than
    ``model_swap_deadline_s`` (0 = none) fails its request with
    :class:`ModelSwapDeadlineError` after it completes, so the retry is
    warm."""

    def __init__(self, cfg: LlamaConfig, params_fn: Callable[[], Any] = None,
                 max_batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 decode_steps: int = 1,
                 warmup: bool = True,
                 warmup_max_prompt_len: Optional[int] = None,
                 models: Optional[Dict[str, Any]] = None,
                 default_model: Optional[str] = None,
                 prefix_cache: bool = True,
                 kv_block_tokens: int = 16,
                 prefix_cache_bytes: int = 256 << 20,
                 model_swap_deadline_s: float = 30.0,
                 device=None):
        self.models: Dict[str, Any] = dict(models or {})
        if params_fn is not None and not self.models:
            self.models[default_model or "default"] = params_fn
        if not self.models:
            raise ValueError("LLMDeployment needs params_fn or models={...}")
        self.default_model = default_model or next(iter(self.models))
        if self.default_model not in self.models:
            raise UnknownModelError(self.default_model, list(self.models))
        self.model_swap_deadline_s = float(model_swap_deadline_s or 0)
        self._loaded: Dict[str, Any] = {}
        self._swap_lock = threading.Lock()
        self.engine = LLMEngine(cfg, self._load_model(self.default_model),
                                max_batch_size=max_batch_size,
                                max_seq_len=max_seq_len,
                                decode_steps=decode_steps,
                                model=self.default_model,
                                prefix_cache=prefix_cache,
                                kv_block_tokens=kv_block_tokens,
                                prefix_cache_bytes=prefix_cache_bytes,
                                device=device)
        self.warmup_s = self.engine.warmup(warmup_max_prompt_len) \
            if warmup else 0.0
        self.engine.start()

    # -- model loading / swapping ---------------------------------------

    def _load_model(self, model: str):
        """A model's weights: what its loader returned the first time."""
        cached = self._loaded.get(model)
        if cached is None:
            src = self.models[model]
            cached = self._loaded[model] = src() if callable(src) else src
        return cached

    def _ensure_model(self, model: str):
        """Make ``model`` the engine's live weight set. The caller holds
        ``_swap_lock``, which also covers its enqueue: no other request
        can slip a different model in between."""
        if model not in self.models:
            raise UnknownModelError(model, list(self.models))
        if self.engine.model == model:
            return
        t0 = time.perf_counter()
        # Drain: every request enqueues under _swap_lock (held by us), so
        # the engine's unfinished requests can only fall, as long as its
        # loop runs. A stopped or dead loop retires nothing: refuse the
        # swap rather than wait under the lock for ever.
        while (left := self.engine.metrics()["unfinished"]):
            if not self.engine.running():
                raise RuntimeError(
                    f"cannot swap to model {model!r}: the engine loop is "
                    f"not running and {left} request(s) of model "
                    f"{self.engine.model!r} are unfinished")
            time.sleep(0.002)
        self.engine.swap_params(self._load_model(model), model)
        took = time.perf_counter() - t0
        if self.model_swap_deadline_s and took > self.model_swap_deadline_s:
            # The swap COMPLETED and the weights stay cached: the
            # caller's retry is warm.
            raise ModelSwapDeadlineError(model, took,
                                         self.model_swap_deadline_s)

    def __call__(self, request: Dict[str, Any]):
        t0 = time.perf_counter()
        params = SamplingParams(
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            stop_token_ids=tuple(request.get("stop_token_ids", ())))
        model = str(request.get("model") or self.default_model)
        priority = _parse_priority(request.get("priority", 1))
        job = str(request.get("job") or request.get("job_id") or "default")
        # Hold the swap lock across ensure + enqueue: a concurrent request
        # for ANOTHER model must not swap the weights between our check
        # and our admission. Tokens are read outside the lock: a queued
        # request pins its model, since any later swap drains it first.
        with self._swap_lock:
            self._ensure_model(model)
            it = self.engine.generate(request["prompt_ids"], params,
                                      stream=True, model=model,
                                      priority=priority, job=job)
        if request.get("stream"):
            def token_stream():
                for i, token in enumerate(it):
                    yield {"token": int(token), "index": i}
            return token_stream()
        tokens = []
        ttft_s = None
        for token in it:
            if ttft_s is None:
                ttft_s = time.perf_counter() - t0
            tokens.append(int(token))
        return {"tokens": tokens,
                "model": model,
                "ttft_s": ttft_s,
                "latency_s": time.perf_counter() - t0}
