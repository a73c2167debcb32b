"""Long-read (HBM tier) path: larger READ_SIZE / MAX_SCORE configs — the
analogue of the reference's DPU-MRAM variants (NW READ_SIZE 1120,
WFA MAX_SCORE 250; ref common.h defaults)."""

import random

import numpy as np

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig
from tests.util import cigar_of, make_pair, pack

R = 264
N = 12


def _pairs():
    rng = random.Random(41)
    out = []
    for _ in range(N):
        plen = rng.randrange(150, R - 30)
        tlen = max(1, plen + rng.choice([-1, 0, 0, 1]))
        out.append(make_pair(rng, plen, tlen, rng.randrange(0, 8)))
    return out


def test_wfa_hbm_longread_matches_oracle():
    from aim_tpu.api import align
    pairs = _pairs()
    pats, txts, pl, tl = pack(pairs, R)
    cfg = AlignConfig(algo="wfa", read_size=R, max_score=40, backtrace=True,
                      adaptive=True, variant="hbm", batch_pairs=16)
    res = align(pats, txts, pl, tl, cfg)
    osc, oops, ob, oe = nat.wfa_align(pats, txts, pl, tl, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=40,
                                      adaptive=True, backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(N):
        assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
            cigar_of(oops[i], ob[i], oe[i])


def test_swg_hbm_int16_cells():
    # The MRAM-tier SWG always uses int16 cells (SURVEY §2.5) — larger
    # MAX_SCORE sentinel exercises that path.
    from aim_tpu.api import align
    pairs = _pairs()
    pats, txts, pl, tl = pack(pairs, R)
    cfg = AlignConfig(algo="swg", read_size=R, max_score=400, variant="hbm",
                      backtrace=True, batch_pairs=16)
    assert cfg.cell_width == 2
    res = align(pats, txts, pl, tl, cfg)
    osc, oops, ob, oe = nat.swg_align(pats, txts, pl, tl, match=0, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=400,
                                      cell_width=2, backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(N):
        assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
            cigar_of(oops[i], ob[i], oe[i])
