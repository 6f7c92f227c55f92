"""Content-addressed KV prefix cache (counterpart of
``edl_tpu/serving/prefix.py``): an admission whose prompt starts with
blocks already filled on this replica skips to its first cold block.

**Hash scheme.**  Prompts are hashed per block with a chain hash:

    h_0 = crc32(block 0 token bytes, seed)
    h_i = crc32(block i token bytes, h_{i-1})

so ``h_i`` names the whole prefix up to and including block i.  A
lookup walks the chain and returns the longest run of published
blocks.  CRC32 is not collision-proof, so every entry stores
``(h_prev, token bytes)`` and a match needs both to equal the probe's:
a colliding hash is a miss, never someone else's K/V.  The hashes are
the JAX package's, bit for bit (same seed, same int32 token bytes).

**Claiming is refcounting, not copying.**  ``claim`` adds an owner to
each matched block (``KVBlockPool.ref``); the admission seeds the
sequence's block run and table with them and starts its chunked
prefill at ``skip = matched_blocks * block_tokens``.  The claimer's
writes all land at positions >= ``skip``, in its own blocks, so shared
blocks are only read.  ``skip`` is capped one block short of the
prompt's end, so the final chunk (which yields the first token) always
runs.

**Publication and eviction.**  When a sequence's prefill completes,
its fully filled prompt blocks are published; at refcount 0 a published
block parks on the pool's cached LRU, and ``alloc`` under pressure
evicts it (``pool.on_evict`` drops the index entry first).

**Generation keying.**  The index is keyed by ``(weights generation,
cache_epoch)``; ``rekey`` to a new key drops the whole index and the
pool's cached blocks at once, so a reused block never carries another
generation's K/V.

An invalidation, a rejected collision and a forced eviction journal a
``serve.prefix`` flight event.

**Chaos** (``chaos=``): ``serve.prefix.hash.skew`` makes the next lookup
that finds a candidate entry treat it as a collision (outcome
``hash_skew_rejected``, ``forced: true``); ``serve.prefix.evicted``
(through ``chaos_tick``, at a token boundary) force-evicts arg LRU
cached blocks (outcome ``chaos_evicted``), as allocation pressure would.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_H_SEED = 0x45444C50  # "EDLP"


class _Entry:
    """One published block: keyed in the index by its chain hash."""

    __slots__ = ("block", "h_prev", "tokens")

    def __init__(self, block: int, h_prev: int, tokens: bytes):
        self.block = block
        self.h_prev = h_prev
        self.tokens = tokens


def chain_hashes(prompt: np.ndarray, block_tokens: int) -> List[int]:
    """The per-block chain hashes of every fully filled block of
    ``prompt`` (the trailing partial block is never hashed: it is
    always private)."""
    bt = int(block_tokens)
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
    out: List[int] = []
    h = _H_SEED
    for i in range(len(toks) // bt):
        h = zlib.crc32(toks[i * bt:(i + 1) * bt].tobytes(), h)
        out.append(h)
    return out


class PrefixCache:
    """Replica-local content-addressed index over a ``KVBlockPool``'s
    published blocks.  The batcher's worker thread makes every change
    except ``_on_evict``, which the pool calls under its lock from
    whichever thread allocates."""

    def __init__(self, pool, block_tokens: int, chaos=None):
        self.pool = pool
        self.block_tokens = int(block_tokens)
        self.chaos = chaos
        #: (weights generation, cache_epoch) the index was built under
        self.key: Optional[Tuple[int, int]] = None
        self._index: Dict[int, _Entry] = {}  # chain hash -> entry
        self._by_block: Dict[int, int] = {}  # block id -> chain hash
        self.stats = {
            "hits": 0, "misses": 0, "blocks_reused": 0,
            "evictions": 0, "invalidations": 0, "skew_rejected": 0,
        }
        pool.on_evict = self._on_evict
        pool.on_reset = self._on_reset

        from edl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self.recorder = telemetry.get_recorder()
        self._m_hits = reg.counter("edl_serve_prefix_hits_total")
        self._m_misses = reg.counter("edl_serve_prefix_misses_total")
        self._m_reused = reg.counter("edl_serve_prefix_blocks_reused_total")
        self._m_evictions = reg.counter("edl_serve_prefix_evictions_total")
        self._g_ratio = reg.gauge("edl_serve_prefix_hit_ratio")

    # -- index maintenance --------------------------------------------------
    def __len__(self) -> int:
        return len(self._index)

    def _on_evict(self, block: int) -> None:
        h = self._by_block.pop(int(block), None)
        if h is not None:
            self._index.pop(h, None)
        self.stats["evictions"] += 1
        self._m_evictions.inc()

    def _on_reset(self) -> None:
        """Pool reset: drop the whole index, without counting the drops
        as evictions (a reset is not capacity pressure)."""
        self._index.clear()
        self._by_block.clear()

    def rekey(self, key: Tuple[int, int]) -> bool:
        """Bind the index to ``(generation, cache_epoch)``.  A changed
        key drops everything the previous one published, before any
        admission under the new key can look up.  Returns True if an
        invalidation happened."""
        if key == self.key:
            return False
        invalidated = self.key is not None
        prev = self.key
        self.key = key
        if invalidated:
            dropped = len(self._index)
            self._index.clear()
            self._by_block.clear()
            self.pool.drop_published()
            self.stats["invalidations"] += 1
            # The counts at the moment of a swap depend on scheduling:
            # they ride the timing field, outside the event's identity.
            self.recorder.record(
                "serve.prefix",
                {"outcome": "invalidated", "from": list(prev), "to": list(key)},
                timing={"entries_dropped": dropped, "hits": self.stats["hits"],
                        "blocks_reused": self.stats["blocks_reused"]},
            )
        return invalidated

    # -- admission side -----------------------------------------------------
    def claim(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Walk the chain for ``prompt`` and claim (add an owner to) the
        longest published run.  Returns ``(blocks, skip_tokens)``,
        ``([], 0)`` on a miss.  The run stops one block short of the
        prompt's end, so the final token is always prefilled."""
        bt = self.block_tokens
        plen = int(len(prompt))
        limit = (plen - 1) // bt  # most claimable blocks
        if limit <= 0:
            return [], 0
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        skew: Optional[bool] = None
        run: List[int] = []
        h_prev = _H_SEED
        for i in range(limit):
            blk = toks[i * bt:(i + 1) * bt].tobytes()
            h = zlib.crc32(blk, h_prev)
            ent = self._index.get(h)
            if ent is None:
                break
            if skew is None:
                # Consulted once per lookup, and only when a candidate
                # entry exists: a cold lookup must not consume the trip.
                skew = self.chaos is not None and bool(
                    self.chaos.due("serve.prefix.hash.skew")
                )
            if skew or ent.h_prev != h_prev or ent.tokens != blk:
                # A chain-hash collision (or a chaos-forced one): a
                # miss, never foreign K/V.
                self.stats["skew_rejected"] += 1
                self.recorder.record(
                    "serve.prefix",
                    {"outcome": "hash_skew_rejected", "forced": bool(skew)},
                    timing={"at_block": i},
                )
                break
            try:
                self.pool.ref(ent.block)
            except Exception:
                break  # evicted between the index read and the claim
            if self._by_block.get(ent.block) != h:
                # Evicted and granted to another sequence between the
                # index read and the ref: the share landed on a foreign
                # private block.  Drop it.
                self.pool.free([ent.block])
                break
            run.append(ent.block)
            h_prev = h
        if run:
            self.stats["hits"] += 1
            self.stats["blocks_reused"] += len(run)
            self._m_hits.inc()
            self._m_reused.inc(len(run))
        else:
            self.stats["misses"] += 1
            self._m_misses.inc()
        total = self.stats["hits"] + self.stats["misses"]
        self._g_ratio.set(self.stats["hits"] / total)
        return run, len(run) * bt

    def publish(self, prompt: np.ndarray, blocks: List[int]) -> int:
        """Index a finished prefill's fully filled prompt blocks (the
        trailing partial block stays private).  Blocks already indexed,
        the ones this sequence claimed among them, are left alone.
        Returns how many new entries were added."""
        bt = self.block_tokens
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        full = min(int(len(toks)) // bt, len(blocks))
        added = 0
        h_prev = _H_SEED
        for i in range(full):
            blk = toks[i * bt:(i + 1) * bt].tobytes()
            h = zlib.crc32(blk, h_prev)
            if h not in self._index and blocks[i] not in self._by_block:
                b = int(blocks[i])
                self.pool.publish(b)
                self._index[h] = _Entry(b, h_prev, blk)
                self._by_block[b] = h
                added += 1
            h_prev = h
        return added

    # -- chaos --------------------------------------------------------------
    def chaos_tick(self) -> None:
        """Fire due ``serve.prefix.evicted`` trips: force-evict LRU
        cached blocks as if allocation pressure demanded it."""
        if self.chaos is None:
            return
        for ev in self.chaos.due("serve.prefix.evicted"):
            want = int(ev.arg or 1)
            got = self.pool.evict_cached(want)
            self.recorder.record(
                "serve.prefix",
                {"outcome": "chaos_evicted", "requested": want},
                timing={"evicted": got},
            )


__all__ = ["PrefixCache", "chain_hashes"]
