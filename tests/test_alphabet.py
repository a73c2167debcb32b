"""Alphabet coverage: every device tier compares raw bytes for equality,
as the reference does (e.g. NW/DPU-WRAM/dpu/nw.c:76-94), so any byte
alphabet is served on device — non-ACGT inputs are reference parity,
not an extension."""

import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig, derive_config
from tests.test_kernels_xla import ALGOS, assert_matches_oracle
from tests.util import pack, random_pairs

ALPHABETS = {"five": "ACGTN", "twenty": "ACDEFGHIKLMNPQRSTVWY"}


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
@pytest.mark.parametrize("name", ["genasm", "nw", "swg", "wfa-adaptive"])
def test_api_alphabet_matches_oracle(name, alphabet):
    symbols = ALPHABETS[alphabet]
    pairs = random_pairs(seed=47, n=64, max_len=28, alphabet=symbols)
    pats, txts, pl, tl = pack(pairs, 32)
    used = set(np.unique(np.concatenate([pats[pats > 0], txts[txts > 0]])))
    assert len(used) > 4 and used <= set(symbols.encode())
    from aim_tpu.api import align
    cfg = AlignConfig(read_size=32, backtrace=True, batch_pairs=64,
                      **ALGOS[name])
    res = align(pats, txts, pl, tl, cfg)
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)


def test_api_long_wfa_twenty_symbol_end_to_end():
    """api.align on a >4-symbol long-read WFA batch stays exact end to
    end."""
    from aim_tpu.api import align
    rng = np.random.default_rng(43)
    cfg = derive_config("wfa", 300, 0.02, backtrace=True, adaptive=True,
                        variant="hbm", batch_pairs=64)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    n, l = 32, 300
    pats = np.zeros((n, cfg.read_size), np.uint8)
    pats[:, :l] = bases[rng.integers(0, 5, (n, l))]
    txts = pats.copy()
    mut = rng.random((n, l)) < 0.02
    txts[:, :l] = np.where(mut, bases[rng.integers(0, 5, (n, l))],
                           txts[:, :l])
    pl = np.full(n, l, np.int32)
    tl = np.full(n, l, np.int32)
    res = align(pats, txts, pl, tl, cfg)
    want, wo, wb, we = nat.wfa_align(pats, txts, pl, tl,
                                     mismatch=cfg.mismatch,
                                     gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                                     max_score=cfg.max_score,
                                     adaptive=True, backtrace=True)
    np.testing.assert_array_equal(res.scores, want)
    for i in range(n):
        assert wo[i][wb[i]:we[i]].tobytes() == \
            res.ops[i][res.begin[i]:res.end[i]].tobytes(), i
