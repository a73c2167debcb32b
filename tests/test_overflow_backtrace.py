"""WFA overflow-backtrace compat flag: by default
both tiers adopt the MRAM variant's skip on score > MAX_SCORE (ref:
WFA/DPU-MRAM/dpu/wfa.c:399-404, the canonical-run behavior);
--overflow-backtrace opts into a DEFINED rendition of the WRAM variant's
backtrace-on-overflow (the reference does it through an out-of-bounds
wavefront read — UB, ref: WFA/DPU-WRAM/dpu/wfa.c:369-376 — so no
bit-exact target exists; the rendition walks from the deepest live
computed level).  Oracle and golden must agree; api.align applies it as
a host post-pass on overflowed pairs."""

import random

import numpy as np

import aim_tpu.native as nat
from aim_tpu.api import align
from aim_tpu.config import derive_config
from aim_tpu.golden import rle, wfa_golden
from tests.util import make_pair, pack


def _overflowing_batch(seed=51, n=24, l=40, max_score=6):
    """Heavily mutated pairs: most exceed a tiny MAX_SCORE."""
    rng = random.Random(seed)
    pairs = [make_pair(rng, l, l + rng.choice([-1, 0, 1]),
                       rng.choice([0, 1, 6, 9, 12])) for _ in range(n)]
    return pack(pairs, 48)


def _cigars(ops, b, e):
    return [rle(ops[i][b[i]:e[i]].tobytes().decode()) for i in range(len(b))]


def test_oracle_matches_golden_on_overflow():
    pats, txts, pl, tl = _overflowing_batch()
    smax = 6
    sc, ops, b, e = nat.wfa_align(pats, txts, pl, tl, mismatch=3, gap_o=4,
                                  gap_e=1, max_score=smax, adaptive=False,
                                  backtrace=True, overflow_backtrace=True)
    assert (sc > smax).any(), "batch must actually overflow"
    for i in range(len(pl)):
        g = wfa_golden(pats[i, :pl[i]].tobytes(), txts[i, :tl[i]].tobytes(),
                       mismatch=3, gap_o=4, gap_e=1, max_score=smax,
                       backtrace=True, overflow_backtrace=True)
        assert g["score"] == sc[i], i
        got = rle(ops[i][b[i]:e[i]].tobytes().decode())
        assert got == g["cigar"], (i, got, g["cigar"])


def test_default_skip_unchanged():
    # Without the flag the MRAM skip stays byte-identical: the ops
    # buffer is the 'M' prefill with begin = max_operations - 1.
    pats, txts, pl, tl = _overflowing_batch(seed=52)
    smax = 6
    sc, ops, b, e = nat.wfa_align(pats, txts, pl, tl, mismatch=3, gap_o=4,
                                  gap_e=1, max_score=smax, adaptive=False,
                                  backtrace=True)
    sc2, ops2, b2, e2 = nat.wfa_align(pats, txts, pl, tl, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=smax,
                                      adaptive=False, backtrace=True,
                                      overflow_backtrace=True)
    np.testing.assert_array_equal(sc, sc2)
    over = sc > smax
    assert over.any()
    for i in np.nonzero(over)[0]:
        assert b[i] == pl[i] + tl[i] - 1 and e[i] == pl[i] + tl[i]
        assert ops[i][b[i]:e[i]].tobytes() == b"M"   # the "1M" skip line
    for i in np.nonzero(~over)[0]:  # non-overflow pairs identical
        assert ops[i][b[i]:e[i]].tobytes() == ops2[i][b2[i]:e2[i]].tobytes()


def test_api_post_pass_applies_compat_cigars():
    pats, txts, pl, tl = _overflowing_batch(seed=53)
    smax = 6
    cfg = derive_config("wfa", 40, 0.01, backtrace=True) \
        .replace(max_score=smax, read_size=48,
                 overflow_backtrace=True, batch_pairs=64)
    res = align(pats, txts, pl, tl, cfg)
    sc, ops, b, e = nat.wfa_align(pats, txts, pl, tl, mismatch=cfg.mismatch,
                                  gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                                  max_score=smax, adaptive=False,
                                  backtrace=True, overflow_backtrace=True)
    np.testing.assert_array_equal(res.scores, sc)
    assert (sc > smax).any()
    for i in range(len(pl)):
        assert res.ops[i][res.begin[i]:res.end[i]].tobytes() == \
            ops[i][b[i]:e[i]].tobytes(), i


def test_cli_flag_parses():
    from aim_tpu.cli import build_parser, config_from_args
    args = build_parser().parse_args(
        ["wfa", "-i", "x", "-l", "100", "-e", "0.01", "-n", "10", "-b",
         "--overflow-backtrace"])
    cfg = config_from_args(args)
    assert cfg.overflow_backtrace
    args2 = build_parser().parse_args(
        ["wfa", "-i", "x", "-l", "100", "-e", "0.01", "-n", "10", "-b"])
    assert not config_from_args(args2).overflow_backtrace
