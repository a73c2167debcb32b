"""AIM_TPU_SORT=1 runs device work in estimated-difficulty order and
restores output order (SURVEY §7.3's termination-divergence mitigation:
similar-difficulty pairs share a kernel tile, each tile's while-loop
exits at its own hardest pair).  Results must be bit-identical to the
unsorted path — including flagged pairs that take the retry/host
fallback — and the flag must be a no-op under sharding."""

import numpy as np
import pytest

from aim_tpu import api
from aim_tpu.config import derive_config
from tests.util import make_pair, pack

import random


def _mixed_difficulty_pairs(seed, n, max_len):
    """Wide spread of error counts so the difficulty sort actually
    permutes (uniform-error batches barely move)."""
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        plen = rng.randrange(10, max_len - 4)
        tlen = max(1, min(max_len, plen + rng.choice([-2, -1, 0, 0, 1, 2])))
        nerr = rng.choice([0, 0, 1, 2, 5, 9, 14])
        pairs.append(make_pair(rng, plen, tlen, nerr))
    return pairs


def _aligned(cfg, arrays, monkeypatch, sort):
    monkeypatch.setenv("AIM_TPU_SORT", "1" if sort else "0")
    return api.align(*arrays, cfg)


@pytest.mark.parametrize("algo", ["nw", "swg", "wfa", "genasm"])
def test_sorted_identical(algo, monkeypatch):
    cfg = derive_config(algo, 40, 0.05, backtrace=True,
                        adaptive=(algo == "wfa"), batch_pairs=64)
    pairs = _mixed_difficulty_pairs(seed=41, n=300, max_len=40)
    arrays = pack(pairs, cfg.read_size)
    order = api._difficulty_order(*arrays)
    assert not np.array_equal(order, np.arange(len(order)))  # really sorts
    base = _aligned(cfg, arrays, monkeypatch, sort=False)
    sort = _aligned(cfg, arrays, monkeypatch, sort=True)
    np.testing.assert_array_equal(base.scores, sort.scores)
    np.testing.assert_array_equal(base.ops, sort.ops)
    np.testing.assert_array_equal(base.begin, sort.begin)
    np.testing.assert_array_equal(base.end, sort.end)
    assert base.n_fallback == sort.n_fallback


def test_sort_exact_under_sharding(monkeypatch):
    # Shard-aware sort: results restored to the idx
    # contract, bit-identical to the oracle, with the sort active on a
    # multi-device mesh.
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = np.array(jax.devices()[:8])
    if len(devs) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = Mesh(devs, ("pairs",))
    sharding = NamedSharding(mesh, P("pairs"))
    monkeypatch.setenv("AIM_TPU_SORT", "1")
    cfg = derive_config("nw", 24, 0.05, backtrace=True, batch_pairs=64)
    pairs = _mixed_difficulty_pairs(seed=43, n=256, max_len=24)
    pats, txts, pl, tl = pack(pairs, cfg.read_size)
    res = api.align(pats, txts, pl, tl, cfg, device_sharding=sharding)
    from aim_tpu import native
    want, wops, wb, we = native.nw_align(
        pats, txts, pl, tl, mismatch=cfg.mismatch, gap_i=cfg.gap_i,
        gap_d=cfg.gap_d, backtrace=True)
    np.testing.assert_array_equal(res.scores, want)
    for i in range(len(pl)):
        assert wops[i][wb[i]:we[i]].tobytes() == \
            res.ops[i][res.begin[i]:res.end[i]].tobytes(), i


def test_deal_order_balances_shards_and_sorts_blocks():
    # The dealt permutation: (a) is a permutation, (b) gives every device
    # block of every chunk a balanced difficulty mix (no block hoards the
    # hardest pairs), (c) keeps each block internally difficulty-sorted.
    n, bs, ndev = 512, 128, 4
    rng = np.random.default_rng(5)
    difficulty = rng.permutation(n).astype(np.int64)
    order = np.argsort(difficulty, kind="stable")
    perm = api._deal_order(order, n, bs, ndev)
    assert sorted(perm) == list(range(n))
    blk = bs // ndev
    for c0 in range(0, n, bs):
        ranks_in_chunk = []
        for d in range(ndev):
            block = perm[c0 + d * blk: c0 + (d + 1) * blk]
            r = difficulty[block]
            assert (np.diff(r) > 0).all(), "block not internally sorted"
            ranks_in_chunk.append(r.mean())
        # balanced: block means within one dealing stride of each other
        assert max(ranks_in_chunk) - min(ranks_in_chunk) < ndev + 1


def test_deal_order_partial_tail_chunk():
    # A tail chunk shorter than bs (and shorter than one block) must
    # still produce a valid permutation.
    n, bs, ndev = 300, 128, 4
    order = np.argsort(np.random.default_rng(9).permutation(n),
                       kind="stable").astype(np.int64)
    perm = api._deal_order(order, n, bs, ndev)
    assert sorted(perm) == list(range(n))


def test_difficulty_order_subsampling():
    # long reads subsample columns; the proxy must still rank a clean
    # pair below a mutated one
    R = 8192
    n = 130
    rng = np.random.default_rng(7)
    base = rng.integers(65, 69, (1, R), dtype=np.uint8)
    pats = np.repeat(base, n, axis=0)
    txts = pats.copy()
    txts[0, ::17] = 90  # pair 0: heavily mutated
    pl = np.full(n, R, np.int32)
    tl = np.full(n, R, np.int32)
    order = api._difficulty_order(pats, txts, pl, tl)
    assert order[-1] == 0  # hardest pair sorts last


def test_sort_default_by_read_size(monkeypatch):
    """The default (no AIM_TPU_SORT in the env) is read_size-gated:
    ON for long-read configs (>= 1024, measured +4.4% e2e at 10 kbp,
    round-4 sweep), OFF for short reads (measured noise); "0"/"1"
    force-override either way."""
    calls = []
    real = api._difficulty_order

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(api, "_difficulty_order", spy)
    monkeypatch.delenv("AIM_TPU_SORT", raising=False)

    short = derive_config("nw", 40, 0.05, backtrace=False, batch_pairs=256)
    pairs = _mixed_difficulty_pairs(seed=43, n=200, max_len=40)
    arrays = pack(pairs, short.read_size)
    api.align(*arrays, short)
    assert not calls  # short reads: sort off by default

    monkeypatch.setenv("AIM_TPU_SORT", "1")
    api.align(*arrays, short)
    assert calls  # explicit "1" overrides the short-read default

    # long-read config: on by default (cheap XLA-tier run, tiny lens)
    calls.clear()
    monkeypatch.delenv("AIM_TPU_SORT", raising=False)
    long_cfg = derive_config("wfa", 1024, 0.001, backtrace=False,
                             adaptive=True, batch_pairs=256)
    n, R = 136, long_cfg.read_size
    rng = np.random.default_rng(3)
    lp = np.zeros((n, R), np.uint8)
    lp[:, :32] = rng.integers(65, 69, (n, 32), dtype=np.uint8)
    lt = lp.copy()
    pl = np.full(n, 32, np.int32)
    tl = np.full(n, 32, np.int32)
    api.align(lp, lt, pl, tl, long_cfg)
    assert calls  # long reads: sort on by default

    monkeypatch.setenv("AIM_TPU_SORT", "0")
    calls.clear()
    api.align(lp, lt, pl, tl, long_cfg)
    assert not calls  # explicit "0" overrides the long-read default
