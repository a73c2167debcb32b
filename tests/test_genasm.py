"""GenASM: the bitvector edit-distance family.  The reference snapshot
ships GenASM only as an empty submodule, so aim-tpu defines and anchors
the semantics: score = bounded Levenshtein distance, CIGAR = the repo NW
walker's unit-cost output (golden/genasm.py)."""

import numpy as np
import pytest

import aim_tpu.native as nat
from tests.util import cigar_of, pack, random_pairs


def _nw_unit(pats, txts, pl, tl):
    return nat.nw_align(pats, txts, pl, tl, mismatch=1, gap_i=1, gap_d=1,
                        backtrace=True)


def test_genasm_golden_matches_nw_unit_costs():
    """External anchor: on alias-free shapes (plen <= tlen — the NW
    oracle deliberately reproduces the reference's flat-tape aliasing
    when plen > tlen, which GenASM does not inherit) the golden must
    byte-match the NW walker at unit costs."""
    from aim_tpu.golden.genasm import genasm_golden
    pairs = [(p, t) if len(p) <= len(t) else (t, p)
             for p, t in random_pairs(seed=61, n=64, max_len=24)]
    R, K = 32, 12
    pats, txts, pl, tl = pack(pairs, R)
    osc, oops, ob, oe = _nw_unit(pats, txts, pl, tl)
    checked = 0
    for i, (p, t) in enumerate(pairs):
        dist, opstr = genasm_golden(p.encode(), t.encode(), K,
                                    backtrace=True)
        if osc[i] <= K:
            assert dist == osc[i], (i, p, t)
            assert opstr.encode() == oops[i][ob[i]:oe[i]].tobytes(), (i, p, t)
            checked += 1
        else:
            assert dist == K + 1
    assert checked > 32


def test_genasm_golden_edge_cases():
    from aim_tpu.golden.genasm import genasm_golden
    cases = [("", "", 0, ""), ("", "AC", 2, "II"), ("AC", "", 2, "DD"),
             ("A", "A", 0, "M"), ("A", "T", 1, "X"),
             ("ACGT", "AGT", 1, "MDMM")]
    for p, t, want_d, want_ops in cases:
        d, o = genasm_golden(p.encode(), t.encode(), 5, backtrace=True)
        assert d == want_d, (p, t, d)
        assert o == want_ops, (p, t, o)


def test_genasm_native_matches_golden():
    from aim_tpu.golden.genasm import genasm_golden
    pairs = random_pairs(seed=67, n=48, max_len=20)
    R, K = 24, 8
    pats, txts, pl, tl = pack(pairs, R)
    sc, ops, b, e = nat.genasm_align(pats, txts, pl, tl, max_score=K,
                                     backtrace=True)
    for i, (p, t) in enumerate(pairs):
        d, o = genasm_golden(p.encode(), t.encode(), K, backtrace=True)
        assert sc[i] == d, (i, p, t)
        if d <= K:
            assert cigar_of(ops[i], b[i], e[i]) == o.encode(), (i, p, t)


def test_genasm_api_and_cli_host_tier(tmp_path):
    """GenASM through api.align (the NW kernel's GenASM mode) and the CLI,
    emitted byte-identical to the host oracle pipeline."""
    from aim_tpu.api import align
    from aim_tpu.cli import main
    from aim_tpu.config import derive_config
    from tests.util import write_pair_file

    pairs = random_pairs(seed=71, n=40, max_len=20)
    cfg = derive_config("genasm", 20, 0.05, backtrace=True)
    assert cfg.max_score == 2 and cfg.mismatch == 1
    pats, txts, pl, tl = pack(pairs, cfg.read_size)
    res = align(pats, txts, pl, tl, cfg)
    assert res.n_fallback == 0
    osc, oops, ob, oe = nat.genasm_align(pats, txts, pl, tl,
                                         max_score=cfg.max_score,
                                         backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(len(pairs)):
        assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
            cigar_of(oops[i], ob[i], oe[i])

    inp = str(tmp_path / "pairs.txt")
    write_pair_file(inp, pairs)
    out = str(tmp_path / "ga.out")
    rc = main(["genasm", "-i", inp, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "40", "-b", "-q"])
    assert rc == 0
    ref = str(tmp_path / "ga.ref")
    nat.emit_output(ref, np.arange(len(osc), dtype=np.int32), osc, oops,
                    ob, oe, True)
    assert open(out, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("backtrace", [True, False])
def test_genasm_hbm_variant_on_device(backtrace):
    """The long-read tier (--variant hbm) at a wider k: same kernel, same
    semantics, every pair served on device — including plen == tlen + 1
    and longer patterns, where GenASM (unlike NW) has no tape aliasing."""
    from aim_tpu.api import align
    from aim_tpu.config import derive_config
    from tests.test_kernels_xla import _long_pattern_pairs

    cfg = derive_config("genasm", 80, 0.1, backtrace=backtrace,
                        variant="hbm", batch_pairs=64)
    assert cfg.max_score == 16 and cfg.variant == "hbm"
    pairs = random_pairs(seed=83, n=32, max_len=84) + \
        _long_pattern_pairs(89, 32, 84)
    pats, txts, pl, tl = pack(pairs, cfg.read_size)
    assert (pl == tl + 1).any() and (pl > tl + 1).any()
    res = align(pats, txts, pl, tl, cfg)
    assert res.n_fallback == 0
    osc, oops, ob, oe = nat.genasm_align(pats, txts, pl, tl,
                                         max_score=cfg.max_score,
                                         backtrace=backtrace)
    np.testing.assert_array_equal(res.scores, osc)
    if backtrace:
        for i in range(len(pairs)):
            assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
                cigar_of(oops[i], ob[i], oe[i]), (i, pairs[i])
