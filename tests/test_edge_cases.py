"""Degenerate inputs (empty/one-char sequences, all-mismatch) through
api.align on every algorithm vs the exact oracle."""

import pytest

from aim_tpu.config import AlignConfig
from tests.test_kernels_xla import ALGOS, assert_matches_oracle
from tests.util import pack

R = 16
EDGE = [("", "ACG"), ("ACG", ""), ("", ""), ("A", "A"), ("A", "T"),
        ("AC", "A"), ("A", "AC"), ("ACGT", "ACGT"), ("AAAA", "TTTT"),
        ("AAAAAAAAAAAAAAAA", "TTTTTTTTTTTTTTTT"), ("ACGTACGT", "A")] * 2


@pytest.mark.parametrize("backtrace", [True, False])
@pytest.mark.parametrize("name", sorted(ALGOS))
def test_edge_cases_match_oracle(name, backtrace):
    from aim_tpu.api import align
    pats, txts, pl, tl = pack(EDGE, R)
    cfg = AlignConfig(read_size=R, backtrace=backtrace, **ALGOS[name])
    res = align(pats, txts, pl, tl, cfg)
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)
    if cfg.algo in ("wfa", "genasm"):
        # the all-mismatch pairs overflow MAX_SCORE
        assert (res.scores == cfg.max_score + 1).any()


def test_swg_int8_wrapping_input_stays_exact():
    """An input that genuinely wraps the reference's int8 tape (all-
    mismatch pair under a hot cost model) must still come back equal to
    the oracle through api.align (the kernel's wrap flags -> oracle)."""
    import numpy as np
    import aim_tpu.native as nat
    from aim_tpu.api import align
    from aim_tpu.config import AlignConfig

    cfg = AlignConfig(algo="swg", variant="vmem", max_score=100,
                      read_size=40, mismatch=5, gap_o=4, gap_e=1,
                      backtrace=True)
    n, l = 8, 40
    pats = np.full((n, 40), ord("A"), np.uint8)
    txts = np.full((n, 40), ord("C"), np.uint8)
    pl = np.full(n, l, np.int32)
    tl = np.full(n, l, np.int32)
    res = align(pats, txts, pl, tl, cfg)
    osc, oops, ob, oe = nat.swg_align(pats, txts, pl, tl, match=0,
                                      mismatch=5, gap_o=4, gap_e=1,
                                      max_score=100, cell_width=1,
                                      backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(n):
        assert oops[i][ob[i]:oe[i]].tobytes() == \
            res.ops[i][res.begin[i]:res.end[i]].tobytes()
