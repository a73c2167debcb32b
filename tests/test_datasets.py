"""Equality on the reference's in-repo datasets (SURVEY.md §4.5) and the
long-read (hbm/MRAM-analogue) tier: device results must match the
exact-semantics oracle bit-for-bit.  Runs on the CPU mesh in CI; the
same comparison at full size on the card is chip_smoke.py.
"""

import os

import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.api import align
from aim_tpu.config import derive_config

REF_SAMPLE = "/root/reference/Datasets/sample-l100-e1-40K"
# Self-contained fallback: the checked-in generator sample keeps these tests green without the reference mount.
LOCAL_SAMPLE = os.path.join(os.path.dirname(__file__), "..", "data",
                            "sample-l100-e1-2K")
SAMPLE = REF_SAMPLE if os.path.exists(REF_SAMPLE) else LOCAL_SAMPLE
N_SUB = 1024  # CPU subset; full-size runs are chip_smoke.py's


def _oracle(algo, cfg, pats, txts, pl, tl):
    if algo == "genasm":
        return nat.genasm_align(pats, txts, pl, tl,
                                max_score=cfg.max_score, backtrace=True)
    if algo == "wfa":
        return nat.wfa_align(pats, txts, pl, tl, mismatch=3, gap_o=4,
                             gap_e=1, max_score=cfg.max_score,
                             adaptive=cfg.adaptive, backtrace=True)
    if algo == "nw":
        return nat.nw_align(pats, txts, pl, tl, mismatch=3, gap_i=4,
                            gap_d=4, backtrace=True)
    return nat.swg_align(pats, txts, pl, tl, match=0, mismatch=3, gap_o=4,
                         gap_e=1, max_score=cfg.max_score,
                         cell_width=cfg.cell_width, backtrace=True)


def _assert_equal(res, osc, oops, ob, oe, n):
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(n):
        assert oops[i][ob[i]:oe[i]].tobytes() == \
            res.ops[i][res.begin[i]:res.end[i]].tobytes(), i


@pytest.mark.parametrize("algo", ["wfa", "nw", "swg"])
def test_sample_dataset_subset_equality(algo):
    cfg = derive_config(algo, 100, 0.01, backtrace=True,
                        adaptive=(algo == "wfa"))
    pats, txts, pl, tl = nat.parse_pairs(SAMPLE, N_SUB, cfg.read_size)
    res = align(pats, txts, pl, tl, cfg)
    _assert_equal(res, *_oracle(algo, cfg, pats, txts, pl, tl), len(pl))


def _synth(n, l, e, seed=0):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = bases[rng.integers(0, 4, (n, l))]
    txts = np.where(rng.random((n, l)) < e,
                    bases[rng.integers(0, 4, (n, l))], pats)
    return pats, txts


@pytest.mark.parametrize("algo,l", [("nw", 600), ("swg", 400), ("wfa", 600)])
def test_longread_hbm_tier_equality(algo, l):
    cfg = derive_config(algo, l, 0.01, backtrace=True, variant="hbm",
                        adaptive=(algo == "wfa"))
    n = 64
    p0, t0 = _synth(n, l, 0.01)
    pats = np.zeros((n, cfg.read_size), np.uint8)
    txts = np.zeros((n, cfg.read_size), np.uint8)
    pats[:, :l] = p0
    txts[:, :l] = t0
    pl = np.full(n, l, np.int32)
    tl = np.full(n, l, np.int32)
    res = align(pats, txts, pl, tl, cfg)
    _assert_equal(res, *_oracle(algo, cfg, pats, txts, pl, tl), n)


def test_vmem_tier_rejects_wram_infeasible():
    """Parity with the reference WRAM launchers' feasibility exit."""
    from aim_tpu.cli import main
    rc = main(["swg", "-i", "/dev/null", "-o", "/tmp/x", "-l", "500",
               "-e", "0.01", "-n", "4", "-b", "-q"])
    assert rc == -1


ERR = "/root/reference/Datasets/ERR240727-l100-e1-30000Pairs"


@pytest.mark.slow
@pytest.mark.skipif(not os.path.exists(REF_SAMPLE),
                    reason="dataset not mounted")
@pytest.mark.parametrize("path,n", [(REF_SAMPLE, 40000), (ERR, 30000)])
@pytest.mark.parametrize("algo", ["wfa", "nw", "swg", "genasm"])
def test_full_dataset_byte_identity(tmp_path, algo, path, n):
    """The BASELINE.md full-dataset claim, reproducible in-tree: the whole
    file-to-file pipeline on both in-repo datasets is byte-identical to
    the oracle's emitted output, with zero fallbacks (pytest -m slow)."""
    from aim_tpu.api import align_file

    cfg = derive_config(algo, 100, 0.01, backtrace=True,
                        adaptive=(algo == "wfa"))
    out = str(tmp_path / f"{algo}.out")
    res = align_file(path, out, n, cfg, verbose=False)
    assert res.n_fallback == 0
    pats, txts, pl, tl = nat.parse_pairs(path, n, cfg.read_size)
    osc, oops, ob, oe = _oracle(algo, cfg, pats, txts, pl, tl)
    ref = str(tmp_path / f"{algo}.ref")
    nat.emit_output(ref, np.arange(len(osc), dtype=np.int32), osc, oops,
                    ob, oe, True)
    assert open(out, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("algo", ["wfa", "nw", "swg", "genasm"])
def test_zero_fallback_on_launcher_configs(algo):
    """The perf story depends on the fast path taking ~every pair: on
    launcher-derived configs over dataset-like synthetic pairs the
    needs_fallback count must be exactly 0 (not merely a majority)."""
    cfg = derive_config(algo, 100, 0.01, backtrace=True,
                        adaptive=(algo == "wfa"))
    n, l = 512, 100
    p0, t0 = _synth(n, l, 0.01, seed=7)
    pats = np.zeros((n, cfg.read_size), np.uint8)
    txts = np.zeros((n, cfg.read_size), np.uint8)
    pats[:, :l] = p0
    txts[:, :l] = t0
    pl = np.full(n, l, np.int32)
    tl = np.full(n, l, np.int32)
    res = align(pats, txts, pl, tl, cfg)
    assert res.n_fallback == 0
    osc, *_ = _oracle(algo, cfg, pats, txts, pl, tl)
    np.testing.assert_array_equal(res.scores, osc)
