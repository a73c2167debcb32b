"""Device kernels (plain XLA) vs the native exact-semantics oracle:
scores AND CIGARs must match on randomized inputs including the
plen == tlen+1 tape-aliasing cases."""

import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig
from tests.util import cigar_of, pack, random_pairs

R = 24
PAIRS = random_pairs(seed=11, n=64, max_len=R)
PACKED = pack(PAIRS, R)


def test_nw_xla_matches_oracle():
    from aim_tpu.ops.nw_xla import nw_forward
    pats, txts, pl, tl = PACKED
    cfg = AlignConfig(algo="nw", read_size=R, backtrace=True)
    out = nw_forward(pats, txts, pl, tl, cfg=cfg)
    sc = np.asarray(out["scores"])
    fb = np.asarray(out["needs_fallback"])
    osc, oops, ob, oe = nat.nw_align(pats, txts, pl, tl, mismatch=3,
                                     gap_i=4, gap_d=4, backtrace=True)
    wops, wb, we = nat.nw_traceback_bits(np.asarray(out["bits"]), pl, tl, 2 * R)
    checked = 0
    for i in range(len(PAIRS)):
        if fb[i]:
            continue  # flagged pairs are rerouted to the oracle by api.align
        checked += 1
        assert sc[i] == osc[i], (i, PAIRS[i])
        assert cigar_of(oops[i], ob[i], oe[i]) == cigar_of(wops[i], wb[i], we[i])
    assert checked >= len(PAIRS) * 0.8


def test_swg_xla_matches_oracle():
    from aim_tpu.ops.swg_xla import swg_forward
    pats, txts, pl, tl = PACKED
    cfg = AlignConfig(algo="swg", read_size=R, max_score=26, backtrace=True)
    out = swg_forward(pats, txts, pl, tl, cfg=cfg)
    sc = np.asarray(out["scores"])
    fb = np.asarray(out["needs_fallback"])
    osc, oops, ob, oe = nat.swg_align(pats, txts, pl, tl, match=0, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=26,
                                      cell_width=1, backtrace=True)
    wops, wb, we = nat.swg_traceback_bits(np.asarray(out["bits"]), pl, tl, 2 * R)
    checked = 0
    for i in range(len(PAIRS)):
        if fb[i]:
            continue
        checked += 1
        assert np.int8(sc[i]) == osc[i], (i, PAIRS[i])
        assert cigar_of(oops[i], ob[i], oe[i]) == cigar_of(wops[i], wb[i], we[i])
    assert checked >= len(PAIRS) * 0.7


@pytest.mark.parametrize("adaptive", [False, True])
def test_wfa_xla_matches_oracle(adaptive):
    from aim_tpu.ops.wfa_xla import wfa_forward
    pats, txts, pl, tl = PACKED
    smax = 15
    cfg = AlignConfig(algo="wfa", read_size=R, max_score=smax,
                      backtrace=True, adaptive=adaptive)
    out = wfa_forward(pats, txts, pl, tl, cfg=cfg)
    sc = np.asarray(out["scores"]).astype(np.int32)
    osc, oops, ob, oe = nat.wfa_align(pats, txts, pl, tl, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=smax,
                                      adaptive=adaptive, backtrace=True)
    np.testing.assert_array_equal(sc, osc)
    K = 2 * smax + 1
    ph = np.asarray(out["packed_hist"])
    pm = np.asarray(out["packed_meta"])
    wops, wb, we = nat.wfa_backtrace_batch(
        ph[:, :, :K], ph[:, :, K:2 * K], ph[:, :, 2 * K:3 * K],
        pm[:, :, 0].astype(np.int32), pm[:, :, 1].astype(np.int32),
        pm[:, :, 2].astype(np.uint8), sc,
        pats, txts, pl, tl, mismatch=3, gap_o=4, gap_e=1, max_score=smax)
    for i in range(len(PAIRS)):
        assert cigar_of(oops[i], ob[i], oe[i]) == cigar_of(wops[i], wb[i], we[i]), \
            (i, PAIRS[i])


def test_api_align_with_fallback():
    """api.align reroutes flagged pairs; end result always equals oracle."""
    from aim_tpu.api import align
    pairs = random_pairs(seed=13, n=48, max_len=R, balanced=False)  # many plen>tlen+1
    pats, txts, pl, tl = pack(pairs, R)
    cfg = AlignConfig(algo="nw", read_size=R, backtrace=True, batch_pairs=32)
    res = align(pats, txts, pl, tl, cfg)
    osc, oops, ob, oe = nat.nw_align(pats, txts, pl, tl, mismatch=3, gap_i=4,
                                     gap_d=4, backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(len(pairs)):
        assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
            cigar_of(oops[i], ob[i], oe[i])


# ---- every algorithm through api.align, on three length mixes ----------

R32 = 32
ALGOS = {
    "nw": dict(algo="nw"),
    "swg": dict(algo="swg", max_score=26),
    "wfa": dict(algo="wfa", max_score=12),
    "wfa-adaptive": dict(algo="wfa", max_score=12, adaptive=True),
    "genasm": dict(algo="genasm", max_score=4),
}


def _long_pattern_pairs(seed, n, max_len):
    """plen >= tlen + 1: the reference's tape-aliasing shapes (NW/SWG
    flag plen > tlen + 1 for the host oracle; GenASM has no aliasing)."""
    import random
    from tests.util import make_pair
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        tlen = rng.randrange(1, max_len - 6)
        p, t = make_pair(rng, tlen + rng.choice([1, 1, 2, 3, 5]), tlen,
                         rng.randrange(0, 3))
        if len(p) >= len(t) + 1:
            out.append((p, t))
    return out


def _mixed_length_pairs(seed, n, max_len):
    """Lengths spread over [0, max_len], empty sequences included."""
    import random
    from tests.util import make_pair
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        plen = rng.randrange(0, max_len + 1)
        tlen = max(0, min(max_len, plen + rng.randrange(-6, 7)))
        out.append(make_pair(rng, plen, tlen, rng.randrange(0, 4)))
    return out


SCENARIOS = {
    "balanced": lambda: random_pairs(seed=17, n=64, max_len=R32 - 4),
    "plen_gt_tlen": lambda: _long_pattern_pairs(19, 64, R32 - 4),
    "mixed": lambda: _mixed_length_pairs(23, 64, R32 - 4),
}


def oracle(cfg, pats, txts, pl, tl):
    """The exact host oracle for cfg (same costs, same semantics)."""
    if cfg.algo == "nw":
        return nat.nw_align(pats, txts, pl, tl, mismatch=cfg.mismatch,
                            gap_i=cfg.gap_i, gap_d=cfg.gap_d,
                            backtrace=cfg.backtrace)
    if cfg.algo == "swg":
        return nat.swg_align(pats, txts, pl, tl, match=cfg.match,
                             mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                             gap_e=cfg.gap_e, max_score=cfg.max_score,
                             cell_width=cfg.cell_width,
                             backtrace=cfg.backtrace)
    if cfg.algo == "genasm":
        return nat.genasm_align(pats, txts, pl, tl, max_score=cfg.max_score,
                                backtrace=cfg.backtrace)
    return nat.wfa_align(pats, txts, pl, tl, mismatch=cfg.mismatch,
                         gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                         max_score=cfg.max_score, adaptive=cfg.adaptive,
                         backtrace=cfg.backtrace)


def assert_matches_oracle(res, cfg, pats, txts, pl, tl):
    """Scores and CIGARs equal the oracle's, and the only pairs left to
    the host are NW/SWG's multi-column tape aliasing (plen > tlen + 1):
    GenASM and WFA pairs are all served on device."""
    multi_alias = int((pl > tl + 1).sum())
    assert res.n_fallback == (multi_alias if cfg.algo in ("nw", "swg")
                              else 0)
    osc, oops, ob, oe = oracle(cfg, pats, txts, pl, tl)
    np.testing.assert_array_equal(res.scores, osc)
    if cfg.backtrace:
        for i in range(len(pl)):
            assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
                cigar_of(oops[i], ob[i], oe[i]), i


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("backtrace", [True, False])
@pytest.mark.parametrize("name", sorted(ALGOS))
def test_device_tier_matches_oracle(name, backtrace, scenario):
    from aim_tpu.api import align
    pairs = SCENARIOS[scenario]()
    pats, txts, pl, tl = pack(pairs, R32)
    cfg = AlignConfig(read_size=R32, backtrace=backtrace, batch_pairs=64,
                      **ALGOS[name])
    res = align(pats, txts, pl, tl, cfg)
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)
    if scenario == "plen_gt_tlen":
        assert (pl > tl + 1).any() and (pl == tl + 1).any()


# ---- the kept XLA formulations against their numpy definitions ----------

def test_gather_lane_matches_numpy():
    from aim_tpu.ops.common import gather_lane
    rng = np.random.default_rng(3)
    x = rng.integers(-1000, 1000, (37, 113)).astype(np.int32)
    idx = rng.integers(0, 113, 37).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(gather_lane(x, idx)),
                                  x[np.arange(37), idx])


@pytest.mark.parametrize("slope", [1, 4])
def test_min_plus_scan_matches_numpy(slope):
    from aim_tpu.ops.common import min_plus_scan
    rng = np.random.default_rng(5)
    z = rng.integers(0, 500, (9, 113)).astype(np.int32)
    want = np.empty_like(z)
    for v in range(z.shape[1]):
        j = np.arange(v + 1)
        want[:, v] = (z[:, :v + 1] + (v - j) * slope).min(axis=1)
    np.testing.assert_array_equal(np.asarray(min_plus_scan(z, slope)), want)


def test_wfa_extend_table_matches_numpy():
    """NM[n, k, h] is the first mismatch position >= h on diagonal k (or
    R), and extend() reads it at each lane's offset."""
    from aim_tpu.ops.wfa_xla import build_nm_table, extend
    pairs = random_pairs(seed=29, n=6, max_len=20)
    pats, txts, pl, tl = pack(pairs, 24)
    smax = 3
    nm = np.asarray(build_nm_table(pats, txts, pl, tl, smax, 24))
    R, K = 24, 2 * smax + 1
    assert nm.shape == (6, K, R + 1) and nm.dtype == np.int16
    for i in range(6):
        for kk in range(K):
            k = kk - smax
            for h in range(R + 1):
                hp = h
                while hp < R and 0 <= hp - k < pl[i] and hp < tl[i] \
                        and pats[i, hp - k] == txts[i, hp]:
                    hp += 1
                assert nm[i, kk, h] == hp, (i, k, h)
    off = np.random.default_rng(1).integers(0, R + 1, (6, K)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(extend(nm, off)),
        np.take_along_axis(nm, off[:, :, None], axis=2)[:, :, 0])
