"""The port's KV prefix cache and refcounted pool, on the CPU.

- ``chain_hashes`` bit-equal to the JAX package's;
- the pool: refcounts, the cached LRU and its eviction under pressure,
  all-or-nothing grants, the double-free guard, ``reset``;
- ``PrefixCache``: longest-run claims, divergence, a block evicted and
  granted again in the middle of a claim, ``rekey``, and pressure that
  never starves admission (the cases of ``tests/test_prefix.py``);
- the JAX and port ``PrefixCache`` return the same claims for the same
  sequence of operations;
- through the batcher, a warm admission gives the cold admission's
  tokens while skipping its claimed blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.serving import KVBlockPool as JaxPool
from edl_tpu.serving import PrefixCache as JaxPrefixCache
from edl_tpu.serving import chain_hashes as jax_chain_hashes
from edl_tpu_torch import telemetry
from edl_tpu_torch.models import get_model
from edl_tpu_torch.serving import (
    BlockOwnershipError,
    DecodeEngine,
    KVBlockPool,
    PrefixCache,
    TokenContinuousBatcher,
    chain_hashes,
)

BT = 16


def _pool(num_blocks=8):
    return KVBlockPool(2, 4, 16, num_blocks=num_blocks, block_tokens=BT,
                       dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("bt", [4, 16])
def test_chain_hashes_bit_equal_to_jax(bt):
    rng = np.random.RandomState(bt)
    for n in (0, 3, bt, 2 * bt + 5, 100):
        p = rng.randint(0, 32000, size=n).astype(np.int64)
        assert chain_hashes(p, bt) == jax_chain_hashes(p, bt)
    p = np.arange(40, dtype=np.int32)
    hs = chain_hashes(p, 16)
    assert len(hs) == 2  # the trailing partial block is never hashed
    q = p.copy()
    q[0] = 99  # block 0 changes every downstream hash
    assert all(a != b for a, b in zip(hs, chain_hashes(q, 16)))
    r = p.copy()
    r[20] = 99  # block 1 only
    hr = chain_hashes(r, 16)
    assert hs[0] == hr[0] and hs[1] != hr[1]


# -- the refcounted pool -----------------------------------------------------


def test_pool_double_free_raises_typed_error():
    pool = _pool()
    got = pool.alloc(2)
    pool.free(got)
    with pytest.raises(BlockOwnershipError, match="without being owned"):
        pool.free([got[0]])
    with pytest.raises(BlockOwnershipError):
        pool.free([pool.num_blocks - 1])
    with pytest.raises(ValueError, match="trash"):
        pool.free([0])
    assert sorted(pool.alloc(pool.usable_blocks)) == list(range(1, pool.num_blocks))


def test_pool_refcount_shares_and_returns_at_zero():
    pool = _pool()
    (b,) = pool.alloc(1)
    pool.ref(b)
    assert pool.refcount(b) == 2
    pool.free([b])
    assert pool.refcount(b) == 1 and pool.free_blocks == pool.usable_blocks - 1
    pool.free([b])
    assert pool.refcount(b) == 0 and pool.free_blocks == pool.usable_blocks
    with pytest.raises(BlockOwnershipError):
        pool.ref(b)


def test_pool_published_blocks_park_on_lru_and_evict_under_pressure():
    pool = _pool(num_blocks=5)
    a = pool.alloc(4)
    for b in a[:2]:
        pool.publish(b)
    pool.free(a)
    assert pool.cached_blocks == 2 and pool.free_blocks == 4 and pool.used_blocks == 0
    pool.ref(a[0])  # revived from the cache
    assert pool.refcount(a[0]) == 1 and pool.cached_blocks == 1
    pool.free([a[0]])
    evicted = []
    pool.on_evict = evicted.append
    grant = pool.alloc(4)
    assert grant is not None and sorted(evicted) == sorted(a[:2])
    assert pool.evictions == 2
    pool.free(grant)
    with pytest.raises(BlockOwnershipError):
        pool.publish(grant[0])  # not owned any more


def test_pool_alloc_still_all_or_nothing_with_cache():
    pool = _pool(num_blocks=5)
    a = pool.alloc(3)
    pool.publish(a[0])
    pool.free(a)
    assert pool.free_blocks == 4
    assert pool.alloc(5) is None
    assert pool.free_blocks == 4 and pool.cached_blocks == 1  # a refusal evicts nothing
    assert pool.evict_cached(3) == 1 and pool.cached_blocks == 0


def test_pool_reset_invalidates_index_without_counting_evictions():
    with telemetry.scoped():
        pool = _pool(num_blocks=6)
        cache = PrefixCache(pool, BT)
        prompt = np.arange(50, dtype=np.int32)
        blocks = pool.alloc(3)
        cache.publish(prompt, blocks)
        pool.free(blocks)
        assert len(cache) == 3 and pool.cached_blocks == 3
        pool.reset()
        assert len(cache) == 0 and cache.claim(prompt) == ([], 0)
        assert cache.stats["evictions"] == 0 and pool.evictions == 0
        assert pool.free_blocks == pool.usable_blocks


# -- the index ---------------------------------------------------------------


def test_prefix_claim_longest_run_and_divergence():
    with telemetry.scoped() as (reg, _):
        pool = _pool(num_blocks=12)
        cache = PrefixCache(pool, BT)
        prompt = np.arange(100, 170, dtype=np.int32)  # 70 tokens
        blocks = pool.alloc(5)
        assert cache.publish(prompt, blocks) == 4
        pool.free(blocks)
        run, skip = cache.claim(prompt)
        assert run == blocks[:4] and skip == 64
        assert all(pool.refcount(b) == 1 for b in run)
        pool.free(run)
        div = prompt.copy()
        div[40] += 1  # inside block 2
        run, skip = cache.claim(div)
        assert run == blocks[:2] and skip == 32
        pool.free(run)
        run, skip = cache.claim(prompt[:64])  # block-aligned: the last stays cold
        assert len(run) == 3 and skip == 48
        pool.free(run)
        misses = cache.stats["misses"]
        assert cache.claim(prompt[:9]) == ([], 0)  # under one block: not a miss
        assert cache.stats["misses"] == misses
        assert reg.counter("edl_serve_prefix_blocks_reused_total").value() == 9
        assert reg.gauge("edl_serve_prefix_hit_ratio").value() == 1.0


def test_prefix_eviction_drops_index_entries():
    with telemetry.scoped():
        pool = _pool(num_blocks=4)
        cache = PrefixCache(pool, BT)
        prompt = np.arange(33, dtype=np.int32)
        blocks = pool.alloc(3)
        cache.publish(prompt, blocks)
        pool.free(blocks)
        assert len(cache) == 2 and pool.cached_blocks == 2
        grant = pool.alloc(3)
        assert len(cache) == 0 and cache.claim(prompt) == ([], 0)
        assert cache.stats["evictions"] == 2
        pool.free(grant)


def test_prefix_claim_revalidates_block_regranted_mid_claim():
    """Between the claim's index read and its ``ref``, another
    allocation evicts the cached block and grants it again: the claim
    must drop that share, not claim a foreign private block."""
    with telemetry.scoped():
        pool = _pool(num_blocks=4)
        cache = PrefixCache(pool, BT)
        prompt = np.arange(33, dtype=np.int32)
        blocks = pool.alloc(3)
        cache.publish(prompt, blocks)
        pool.free(blocks)
        real_ref, foreign = pool.ref, []

        def racing_ref(b):
            if not foreign:
                foreign.extend(pool.alloc(2))  # evicts and grants both
            real_ref(b)

        pool.ref = racing_ref
        try:
            assert cache.claim(prompt) == ([], 0)
        finally:
            pool.ref = real_ref
        assert blocks[0] in foreign
        assert all(pool.refcount(b) == 1 for b in foreign)
        pool.free(foreign)


def test_prefix_rekey_invalidates_atomically():
    with telemetry.scoped():
        pool = _pool(num_blocks=8)
        cache = PrefixCache(pool, BT)
        assert cache.rekey((0, 0)) is False
        prompt = np.arange(50, dtype=np.int32)
        blocks = pool.alloc(3)
        cache.publish(prompt, blocks)
        pool.free(blocks)
        assert cache.rekey((0, 0)) is False and len(cache) == 3
        assert cache.rekey((1, 0)) is True
        assert len(cache) == 0 and pool.cached_blocks == 0
        assert pool.free_blocks == pool.usable_blocks
        assert cache.claim(prompt) == ([], 0)
        assert cache.stats["invalidations"] == 1


def test_jax_and_port_prefix_caches_claim_alike():
    """The same operations on a JAX pool + cache and on the port's give
    the same claims, skips, index sizes and stats at every step."""
    from edl_tpu import telemetry as jax_telemetry

    rng = np.random.RandomState(5)
    base = rng.randint(3, 256, size=70).astype(np.int32)
    tail = rng.randint(3, 256, size=30).astype(np.int32)
    prompts = [base, base[:40], np.concatenate([base[:32], tail]), base, tail, base[:17]]
    with jax_telemetry.scoped(), telemetry.scoped():
        jpool = JaxPool(2, 4, 16, num_blocks=9, block_tokens=BT, dtype=jnp.bfloat16, sharding=None)
        tpool = _pool(num_blocks=9)
        jc, tc = JaxPrefixCache(jpool, BT), PrefixCache(tpool, BT)
        for key in ((1, 0), (2, 0)):
            assert jc.rekey(key) == tc.rekey(key)
            for p in prompts:
                jrun, jskip = jc.claim(p)
                trun, tskip = tc.claim(p)
                assert (trun, tskip) == (jrun, jskip)
                need = -(-len(p) // BT) - len(jrun)
                jgot, tgot = jpool.alloc(need), tpool.alloc(need)
                assert tgot == jgot  # None alike under pressure
                if tgot is None:
                    jpool.free(jrun)
                    tpool.free(trun)
                    continue
                assert jc.publish(p, jrun + jgot) == tc.publish(p, trun + tgot)
                jpool.free(jrun + jgot)
                tpool.free(trun + tgot)
                assert (len(tc), tpool.cached_blocks, tpool.free_blocks) == (
                    len(jc), jpool.cached_blocks, jpool.free_blocks)
        for k in ("hits", "misses", "blocks_reused", "evictions", "invalidations"):
            assert tc.stats[k] == jc.stats[k], k


# -- through the batcher -----------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    model = get_model("transformer_lm", tiny=True, dtype=torch.float32)
    eng = DecodeEngine(model, device="cpu", max_seqs=4, block_tokens=BT, num_blocks=9,
                       max_chunk_tokens=16)
    eng.install_seeded(1, step=1)
    return eng


def _gen(gen, prompt, n=4):
    return gen.submit_generate({"tokens": list(prompt)}, max_new_tokens=n,
                               deadline_s=60.0).result(timeout=60)


def test_warm_admission_gives_the_cold_tokens(engine):
    with telemetry.scoped():
        gen = TokenContinuousBatcher(engine, refresh=False).start()
        try:
            rng = np.random.RandomState(1)
            prompt = rng.randint(3, 256, size=40)
            cold_t, cold_m = _gen(gen, prompt)
            warm_t, warm_m = _gen(gen, prompt)
            base = rng.randint(3, 256, size=48)
            _gen(gen, base)
            div_t, div_m = _gen(gen, list(base[:32]) + list(rng.randint(3, 256, size=10)))
        finally:
            gen.stop()
    assert cold_m["reused_blocks"] == 0
    assert warm_m["reused_blocks"] == 2  # (40 - 1) // 16 blocks
    assert warm_m["prefill_chunks"] < cold_m["prefill_chunks"]
    assert warm_t == cold_t
    assert div_m["reused_blocks"] == 2  # the shared 32-token run only
    assert engine.pool.used_blocks == 0


def test_prefix_disabled_is_the_cold_baseline(engine):
    with telemetry.scoped():
        gen = TokenContinuousBatcher(engine, refresh=False, prefix_cache=False).start()
        try:
            prompt = np.random.RandomState(6).randint(3, 256, size=40)
            t1, m1 = _gen(gen, prompt)
            t2, m2 = _gen(gen, prompt)
        finally:
            gen.stop()
    assert gen.prefix is None and m2["reused_blocks"] == 0
    assert m2["prefill_chunks"] == m1["prefill_chunks"] and t1 == t2
    assert engine.pool.used_blocks == 0


def test_prefix_pressure_never_starves_admission(engine):
    """Cached runs fill the 8-block pool; a prompt needing more blocks
    than the free list holds still admits (LRU eviction inside alloc)."""
    with telemetry.scoped():
        gen = TokenContinuousBatcher(engine, refresh=False).start()
        try:
            rng = np.random.RandomState(7)
            for _ in range(3):
                _gen(gen, rng.randint(3, 256, size=33), n=2)
            assert engine.pool.cached_blocks >= 4
            toks, _ = _gen(gen, rng.randint(3, 256, size=60), n=2)
            assert len(toks) == 2 and gen.prefix.stats["evictions"] >= 1
        finally:
            gen.stop()
    assert engine.pool.used_blocks == 0
