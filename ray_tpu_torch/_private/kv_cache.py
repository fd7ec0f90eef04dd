"""Prefix/KV-cache decision core: block-granular prefix tree with
refcounts, LRU eviction, and per-tenant byte charges.

A copy of ``ray_tpu/_private/kv_cache.py`` (the port imports nothing of
``ray_tpu``), with the same semantics, exceptions, hash bytes and
``perf_stats`` counters (``llm_kv_cache_{hits,misses,evictions,bytes}``),
and one cut: no ``sanitize_hooks`` taps. Those gate the reference's
rayspec and raymc tools, which are not ported.

This is the *decision* half of a prefix cache: which blocks exist, who
may read them, which block is evicted under pressure, and which tenant
pays for the bytes. The PAYLOAD (the KV tensors) lives outside, in
``serve/llm.py``'s host store, so this core stays pure: a lock, dicts and
counters.

Chain keys: a prompt is split into fixed ``block_tokens`` chunks; each
chunk's key is a hash of (parent key, chunk tokens, seed), so a key
identifies the chunk AND its entire prefix: two prompts share a block
exactly when they share the whole head up to it. The ``seed`` carries
the model identity (multi-model replicas must never cross-hit).

Contracts:

- a block with a nonzero refcount (a reader copied it into a slot, or
  an admit is still filling it) is NEVER evicted: a hit never yields
  freed bytes;
- refcounts never go negative: ``release`` without a matching
  ``lookup``/``pin``/``admit`` hold raises;
- per-tenant charge is conserved: a job's charge equals the bytes of
  its resident blocks, across every admit/evict interleaving;
- resident bytes never exceed ``capacity_bytes``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import perf_stats


def chunk_hash(parent: str, tokens: Sequence[int], seed: str = "") -> str:
    """Key of one token chunk given its parent chunk's key. Stable
    across processes and replicas, and equal to the reference's."""
    h = hashlib.blake2b(digest_size=12)
    h.update(parent.encode())
    h.update(b"|")
    h.update(seed.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


def chain_keys(tokens: Sequence[int], block_tokens: int,
               seed: str = "") -> List[str]:
    """Hash-chain keys for every FULL ``block_tokens`` chunk of
    ``tokens`` (the partial tail chunk is never cached)."""
    if block_tokens <= 0:
        return []
    keys: List[str] = []
    parent = ""
    n_full = len(tokens) - len(tokens) % block_tokens
    for i in range(0, n_full, block_tokens):
        parent = chunk_hash(parent, tokens[i:i + block_tokens], seed)
        keys.append(parent)
    return keys


@dataclasses.dataclass(frozen=True)
class BlockHandle:
    """A pinned reference to a resident block: ``block_id`` names the
    payload generation (a re-admitted key gets a fresh id, so a stale
    payload read is detectable), ``index`` is the chunk position."""

    key: str
    block_id: int
    index: int


@dataclasses.dataclass(frozen=True)
class EvictedBlock:
    key: str
    block_id: int
    job: str
    nbytes: int
    index: int


class _Block:
    __slots__ = ("key", "block_id", "job", "nbytes", "refs", "index")

    def __init__(self, key, block_id, job, nbytes, index):
        self.key = key
        self.block_id = block_id
        self.job = job
        self.nbytes = nbytes
        self.refs = 1
        self.index = index


class PrefixCache:
    """The decision core. Thread-safe; every public op is one lock
    hold. See the module docstring for the contract."""

    def __init__(self, capacity_bytes: int, block_tokens: int):
        self.capacity_bytes = int(capacity_bytes)
        self.block_tokens = int(block_tokens)
        self._lock = threading.Lock()
        self._blocks: Dict[str, _Block] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # LRU→MRU
        self._charge: Dict[str, int] = {}
        self._bytes = 0
        self._ids = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._c_hits = perf_stats.counter("llm_kv_cache_hits")
        self._c_misses = perf_stats.counter("llm_kv_cache_misses")
        self._c_evict = perf_stats.counter("llm_kv_cache_evictions")
        self._c_bytes = perf_stats.counter("llm_kv_cache_bytes")

    # -- read path --------------------------------------------------------

    def lookup(self, chain: Sequence[str],
               job: str = "default") -> List[BlockHandle]:
        """Longest resident prefix of ``chain``, each block PINNED
        (refs+1) so no concurrent admit/evict frees it while the caller
        copies the payload. Callers must :meth:`release` every handle."""
        chain = tuple(chain)
        out: List[BlockHandle] = []
        with self._lock:
            for i, key in enumerate(chain):
                block = self._blocks.get(key)
                if block is None:
                    break
                block.refs += 1
                self._lru.move_to_end(key)
                out.append(BlockHandle(key, block.block_id, i))
            self.hits += len(out)
            self.misses += len(chain) - len(out)
        self._c_hits.inc(len(out))
        self._c_misses.inc(len(chain) - len(out))
        return out

    def pin(self, handles: Sequence[BlockHandle]) -> None:
        """Extra refs on already-held handles (e.g. one copy-in per
        destination slot). Pinning a block the caller does not hold is
        a bug and raises."""
        with self._lock:
            for h in handles:
                block = self._blocks.get(h.key)
                if block is None or block.block_id != h.block_id \
                        or block.refs < 1:
                    raise ValueError(
                        f"pin of unheld block {h.key!r}")
            for h in handles:
                self._blocks[h.key].refs += 1

    def release(self, handles: Sequence[BlockHandle]) -> None:
        """Drop one ref per handle. A release past zero means a caller
        double-released (a freed-bytes-in-flight bug) and raises."""
        with self._lock:
            for h in handles:
                block = self._blocks.get(h.key)
                if block is None or block.refs < 1:
                    raise ValueError(
                        f"release without a matching hold on {h.key!r}")
            for h in handles:
                self._blocks[h.key].refs -= 1

    # -- write path -------------------------------------------------------

    def admit(self, chain: Sequence[str], job: str, nbytes: int) \
            -> Tuple[List[BlockHandle], List[EvictedBlock]]:
        """Insert the missing blocks of ``chain`` (``nbytes`` each,
        charged to ``job``), evicting LRU unpinned blocks for space.
        Created blocks come back PINNED (refs=1) so the caller can
        store the payload before any evict can touch them; the caller
        must :meth:`release` them afterwards. Admission stops at the
        first block that cannot fit (everything evictable is pinned):
        a child without its parent resident can never be looked up, so
        a partial-prefix admit is the correct degradation."""
        chain = tuple(chain)
        nbytes = int(nbytes)
        created: List[BlockHandle] = []
        evicted: List[EvictedBlock] = []
        with self._lock:
            for i, key in enumerate(chain):
                block = self._blocks.get(key)
                if block is not None:
                    self._lru.move_to_end(key)
                    continue
                if nbytes > self.capacity_bytes:
                    break
                while self._bytes + nbytes > self.capacity_bytes:
                    victim = self._evict_one_locked()
                    if victim is None:
                        break
                    evicted.append(victim)
                if self._bytes + nbytes > self.capacity_bytes:
                    break  # everything evictable is pinned
                block = _Block(key, next(self._ids), job, nbytes, i)
                self._blocks[key] = block
                self._lru[key] = None
                self._bytes += nbytes
                self._charge[job] = self._charge.get(job, 0) + nbytes
                created.append(BlockHandle(key, block.block_id, i))
            self.evictions += len(evicted)
        delta = nbytes * len(created) - sum(e.nbytes for e in evicted)
        self._c_bytes.inc(delta)
        self._c_evict.inc(len(evicted))
        return created, evicted

    def evict(self, nbytes: int) -> List[EvictedBlock]:
        """Free at least ``nbytes`` of UNPINNED LRU blocks (or as much
        as is evictable): the memory-pressure entry point."""
        out: List[EvictedBlock] = []
        with self._lock:
            freed = 0
            while freed < nbytes:
                victim = self._evict_one_locked()
                if victim is None:
                    break
                freed += victim.nbytes
                out.append(victim)
            self.evictions += len(out)
        self._c_bytes.inc(-sum(e.nbytes for e in out))
        self._c_evict.inc(len(out))
        return out

    def _evict_one_locked(self) -> Optional[EvictedBlock]:
        """LRU victim among refs==0 blocks; None when every block is
        pinned. A pinned block is NEVER chosen: the core contract."""
        for key in self._lru:
            block = self._blocks[key]
            if block.refs == 0:
                del self._blocks[key]
                del self._lru[key]
                self._bytes -= block.nbytes
                left = self._charge.get(block.job, 0) - block.nbytes
                if left > 0:
                    self._charge[block.job] = left
                else:
                    self._charge.pop(block.job, None)
                return EvictedBlock(key, block.block_id, block.job,
                                    block.nbytes, block.index)
        return None

    # -- observation ------------------------------------------------------

    def hot_digests(self, top_n: int = 32) -> List[str]:
        """MRU-first resident block keys (bounded): the digest that
        cache-affinity routing reads."""
        with self._lock:
            out = []
            for key in reversed(self._lru):
                out.append(key)
                if len(out) >= top_n:
                    break
            return out

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._blocks

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def charges(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._charge)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "blocks": len(self._blocks),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
