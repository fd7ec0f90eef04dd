"""The port's prefix/KV-cache decision core (ray_tpu_torch._private.kv_cache)
against the reference's (ray_tpu._private.kv_cache): the six tests of
tests/core/test_kv_cache.py on the port's PrefixCache, the chain keys
string for string, and one seeded random stream of operations on both
cores, every return value, stats(), charges() and exception type equal at
each step.
"""

import dataclasses
import threading

import numpy as np
import pytest

from ray_tpu._private import kv_cache as ref
from ray_tpu_torch._private.kv_cache import (
    BlockHandle,
    PrefixCache,
    chain_keys,
    chunk_hash,
)

_BT = 4
_NB = 64  # block payload bytes used throughout


def _chain(tokens):
    return chain_keys(tokens, _BT, seed="test")


def test_chain_keys_commit_to_prefix_and_seed():
    toks = list(range(12))
    keys = _chain(toks)
    assert len(keys) == 3  # full chunks only
    assert _chain(toks[:11]) == keys[:2]  # partial tail never keyed
    # A different earlier token changes EVERY later key (hash chain).
    other = _chain([99] + toks[1:])
    assert all(a != b for a, b in zip(keys, other))
    # A different seed (= model identity) is fully disjoint.
    assert not set(keys) & set(chain_keys(toks, _BT, seed="other"))


def test_lookup_longest_resident_prefix_and_counters():
    pc = PrefixCache(capacity_bytes=_NB * 8, block_tokens=_BT)
    chain = _chain(list(range(16)))  # 4 blocks
    created, evicted = pc.admit(chain[:3], "job-a", _NB)
    assert [h.key for h in created] == list(chain[:3]) and not evicted
    pc.release(created)

    hit = pc.lookup(chain)
    assert [h.key for h in hit] == list(chain[:3])
    assert pc.stats()["hits"] == 3 and pc.stats()["misses"] == 1
    pc.release(hit)

    # Handles carry the chunk position, so a sub-chain lookup pins
    # exactly the blocks it names.
    hit1 = pc.lookup(chain[:1])
    assert [h.index for h in hit1] == [0]
    pc.release(hit1)


def test_pinned_blocks_never_evicted_lru_order_and_charges():
    pc = PrefixCache(capacity_bytes=_NB * 2, block_tokens=_BT)
    c1 = _chain([1, 2, 3, 4])
    c2 = _chain([5, 6, 7, 8])
    c3 = _chain([9, 10, 11, 12])
    h1, _ = pc.admit(c1, "job-a", _NB)
    h2, _ = pc.admit(c2, "job-b", _NB)
    assert pc.charges() == {"job-a": _NB, "job-b": _NB}

    # Both resident blocks are pinned: admitting a third cannot evict
    # them; it degrades to a no-op admit instead of freeing held KV.
    h3, evicted = pc.admit(c3, "job-c", _NB)
    assert h3 == [] and evicted == []
    assert pc.contains(c1[0]) and pc.contains(c2[0])

    # Unpin c1 only: now c1 (LRU, unpinned) is the victim; c2 (still
    # pinned) survives. The evicted block's charge moves off job-a.
    pc.release(h1)
    h3, evicted = pc.admit(c3, "job-c", _NB)
    assert [h.key for h in h3] == list(c3)
    assert [e.key for e in evicted] == list(c1)
    assert not pc.contains(c1[0]) and pc.contains(c2[0])
    assert pc.charges() == {"job-b": _NB, "job-c": _NB}
    assert pc.resident_bytes == 2 * _NB
    pc.release(h2)
    pc.release(h3)


def test_refcount_misuse_raises_typed():
    pc = PrefixCache(capacity_bytes=_NB * 4, block_tokens=_BT)
    created, _ = pc.admit(_chain([1, 2, 3, 4]), "j", _NB)
    pc.release(created)
    with pytest.raises(ValueError):
        pc.release(created)  # double release = freed-bytes-in-flight
    with pytest.raises(ValueError):
        pc.pin([BlockHandle("no-such-key", 1, 0)])
    stale = BlockHandle(created[0].key, created[0].block_id + 999, 0)
    with pytest.raises(ValueError):
        pc.pin([stale])  # wrong generation: a re-admitted key


def test_evict_frees_only_unpinned_and_digests_are_mru():
    pc = PrefixCache(capacity_bytes=_NB * 8, block_tokens=_BT)
    ca = _chain(list(range(8)))       # 2 blocks, will stay pinned
    cb = _chain(list(range(50, 58)))  # 2 blocks, released
    ha, _ = pc.admit(ca, "j", _NB)
    hb, _ = pc.admit(cb, "j", _NB)
    pc.release(hb)
    out = pc.evict(_NB * 8)
    assert {e.key for e in out} == set(cb)
    assert pc.resident_bytes == 2 * _NB
    assert set(pc.hot_digests(8)) == set(ca)
    pc.release(ha)


def test_concurrent_admit_lookup_evict_is_safe():
    """Race the full op surface from many threads; no negative refs,
    pinned never evicted and charge conservation must hold under every
    interleaving."""
    pc = PrefixCache(capacity_bytes=_NB * 6, block_tokens=_BT)
    chains = [_chain(list(range(base, base + 12)))
              for base in (0, 100, 200, 300)]
    errors = []

    def worker(chain, job):
        try:
            for _ in range(25):
                hit = pc.lookup(chain, job)
                pc.pin(hit)
                pc.release(hit)
                created, _evicted = pc.admit(chain, job, _NB)
                pc.release(created)
                pc.release(hit)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    def evictor():
        try:
            for _ in range(40):
                pc.evict(_NB)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(c, f"job-{i}"))
               for i, c in enumerate(chains)]
    threads.append(threading.Thread(target=evictor))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    # Quiesced: nothing is pinned, so resident bytes equal the sum of
    # per-job charges (conservation) and everything is evictable.
    assert pc.resident_bytes == sum(pc.charges().values())
    pc.evict(pc.resident_bytes)
    assert pc.resident_bytes == 0
    assert pc.charges() == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_are_the_reference_strings(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        tokens = rng.integers(0, 128256, int(rng.integers(0, 200))).tolist()
        block = int(rng.integers(1, 33))
        key_seed = f"m{int(rng.integers(0, 1000))}|16x2048x8x131072|{block}"
        parent = "" if rng.random() < 0.3 else f"{rng.random():.6f}"
        assert chunk_hash(parent, tokens[:block], key_seed) \
            == ref.chunk_hash(parent, tokens[:block], key_seed)
        assert chain_keys(tokens, block, key_seed) \
            == ref.chain_keys(tokens, block, key_seed)
    assert chain_keys(list(range(8)), 0) == ref.chain_keys(
        list(range(8)), 0) == []


def _plain(x):
    """A return value of either core in a form the two can share."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_op_stream_matches_the_reference(seed):
    """One seeded stream of lookup, pin, release, admit and evict on both
    cores (and the observers between them): each step's return value (or
    exception type), stats() and charges() are equal. Held handles are
    kept side by side, so the same hold is pinned or released on both;
    the stream also releases and pins what is not held."""
    rng = np.random.default_rng(seed)
    cap, block = _NB * int(rng.integers(3, 12)), _BT
    port, refc = PrefixCache(cap, block), ref.PrefixCache(cap, block)
    # Chains that share heads, so lookups hit partway and admits extend.
    heads = [rng.integers(0, 50, 4 * block).tolist() for _ in range(3)]
    chains = []
    for _ in range(8):
        head = heads[int(rng.integers(0, 3))][:block * int(
            rng.integers(0, 5))]
        tail = rng.integers(0, 50, block * int(rng.integers(0, 4))).tolist()
        chains.append(chain_keys(head + tail, block, "seed"))
    held = []  # (port handle, reference handle)

    def both(name, *args, held_args=None):
        outs = []
        for cache, side in ((port, 0), (refc, 1)):
            a = args if held_args is None else (
                [h[side] for h in held_args],)
            try:
                outs.append(("ok", getattr(cache, name)(*a)))
            except Exception as e:  # noqa: BLE001 - compared below
                outs.append(("raised", type(e).__name__))
        assert _plain(outs[0]) == _plain(outs[1]), (name, args, outs)
        return outs

    def pick():
        n = int(rng.integers(0, min(len(held), 4) + 1))
        idx = rng.choice(len(held), n, replace=False) if n else []
        return [held[i] for i in idx]

    for step in range(400):
        op = rng.choice(["lookup", "admit", "release", "pin", "evict",
                         "bad_release", "stale_pin", "observe"])
        chain = chains[int(rng.integers(0, len(chains)))]
        job = f"job-{int(rng.integers(0, 3))}"
        if op == "lookup":
            (_, p), (_, r) = both("lookup", chain, job)
            held += list(zip(p, r))
        elif op == "admit":
            nbytes = _NB * int(rng.integers(1, 3))
            (_, (pc, _)), (_, (rc, _)) = both("admit", chain, job, nbytes)
            held += list(zip(pc, rc))
        elif op == "release" and held:
            chosen = pick()
            both("release", held_args=chosen)
            for h in chosen:
                held.remove(h)
        elif op == "pin" and held:
            chosen = pick()
            both("pin", held_args=chosen)
            held += chosen
        elif op == "evict":
            both("evict", _NB * int(rng.integers(0, 4)))
        elif op == "bad_release":
            # A key that no hold of the stream names: resident with no
            # ref, evicted, or never admitted.
            key = chain[0] if chain and all(
                p.key != chain[0] for p, _ in held) else "no-such-key"
            both("release", held_args=[(BlockHandle(key, 1, 0),
                                        ref.BlockHandle(key, 1, 0))])
        elif op == "stale_pin" and held:
            p, r = held[int(rng.integers(0, len(held)))]
            both("pin", held_args=[(
                BlockHandle(p.key, p.block_id + 1, p.index),
                ref.BlockHandle(r.key, r.block_id + 1, r.index))])
        elif op == "observe":
            both("hot_digests", int(rng.integers(1, 10)))
            if chain:
                both("contains", chain[-1])
            assert port.resident_bytes == refc.resident_bytes
        assert port.stats() == refc.stats(), step
        assert port.charges() == refc.charges(), step
    # Every hold released on both leaves everything evictable.
    both("release", held_args=held)
    both("evict", cap)
    assert port.stats() == refc.stats()
    assert port.stats()["blocks"] == 0 and port.charges() == {}
