"""The in-repo data layer (aim_tpu.datagen + `aim-tpu gen`): generator
semantics, pair-file grammar round-trip through the native parser, and
the checked-in sample's integrity (the generator mirrors the WFA repo tool the reference points at, Datasets/README.md:
18-26)."""

import math
import os

import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.datagen import generate_pairs, write_pair_file

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def test_generate_pairs_shapes_and_edit_budget():
    n, l, e = 64, 100, 0.05
    pats, txts, pl, tl = generate_pairs(n, l, e, seed=3)
    assert pats.shape == txts.shape == (n, 112)  # roundup8(100+5)=112
    assert (pl == l).all()
    k = math.ceil(l * e)
    # Each edit shifts the text length by at most 1.
    assert (np.abs(tl - l) <= k).all()
    # Every pair got real edits: at least one byte differs (a mismatch
    # always substitutes a different base).
    diff = (pats != txts).any(axis=1) | (pl != tl)
    assert diff.all()
    # Deterministic under the same seed.
    p2, t2, *_ = generate_pairs(n, l, e, seed=3)
    np.testing.assert_array_equal(pats, p2)
    np.testing.assert_array_equal(txts, t2)


def test_pair_file_roundtrip_through_native_parser(tmp_path):
    path = str(tmp_path / "gen.pairs")
    n, l, e = 50, 120, 0.02
    write_pair_file(path, n, l, e, seed=9)
    pats, txts, pl, tl = generate_pairs(n, l, e, read_size=136, seed=9)
    pp, pt, ppl, ptl = nat.parse_pairs(path, n, 136)
    np.testing.assert_array_equal(pats, pp)
    np.testing.assert_array_equal(txts, pt)
    np.testing.assert_array_equal(pl, ppl)
    np.testing.assert_array_equal(tl, ptl)


def test_gen_cli_and_oracle_consume(tmp_path):
    from aim_tpu.cli import main
    path = str(tmp_path / "cli.pairs")
    rc = main(["gen", "-o", path, "-n", "32", "-l", "80", "-e", "0.03"])
    assert rc == 0
    pats, txts, pl, tl = nat.parse_pairs(path, 32, 96)
    scores, *_ = nat.wfa_align(pats, txts, pl, tl, mismatch=3, gap_o=4,
                               gap_e=1, max_score=250, adaptive=True,
                               backtrace=True)
    assert len(scores) == 32
    assert (scores >= 0).all()


def test_checked_in_sample_parses_and_scores():
    sample = os.path.join(DATA, "sample-l100-e1-2K")
    assert os.path.exists(sample), "checked-in sample missing"
    pats, txts, pl, tl = nat.parse_pairs(sample, 1000, 112)
    assert len(pl) == 1000
    assert pl.max() <= 112 and tl.max() <= 112
    # Regenerable: the file is exactly the generator's seed-0 output.
    from aim_tpu.datagen import generate_texts
    p0, t0 = next(generate_texts(1, 100, 0.01, seed=0))
    assert pats[0, :len(p0)].tobytes() == p0.tobytes()
    assert txts[0, :len(t0)].tobytes() == t0.tobytes()


def test_generate_rejects_too_small_read_size():
    with pytest.raises(ValueError):
        generate_pairs(4, 100, 0.01, read_size=96, seed=1)
