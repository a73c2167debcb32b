"""Cross-cost-model fuzz harness: device kernels vs the exact oracle.

Runs random pair batches through `aim_tpu.api.align` under deliberately
NON-default cost models (cheap gaps, ge > go, wide bands, overflow-heavy
data, both memory tiers) and asserts byte-level score+CIGAR equality with
the `aim_tpu.native` oracle for every pair (flagged pairs take the
oracle inside align).  Kernel defects have shown up only under such
models — run this after ANY kernel change, on the card when available:

    python tools/fuzz_kernels.py [seed0 [n_seeds]]
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")  # repo root

from aim_tpu.config import AlignConfig  # noqa: E402
from aim_tpu.api import align  # noqa: E402
import aim_tpu.native as nat  # noqa: E402
from tests.util import pack, random_pairs  # noqa: E402

CONFIGS = [
    ("nw", 48, dict(max_score=12, gap_i=2, gap_d=5, mismatch=1),
     dict(mismatch=1, gap_i=2, gap_d=5)),
    ("nw", 48, dict(max_score=16, gap_i=1, gap_d=1, mismatch=4),
     dict(mismatch=4, gap_i=1, gap_d=1)),
    ("nw", 96, dict(max_score=24, gap_i=3, gap_d=2, mismatch=2,
                    variant="hbm"),
     dict(mismatch=2, gap_i=3, gap_d=2)),
    ("swg", 48, dict(max_score=30, match=0, mismatch=5, gap_o=6, gap_e=2),
     dict(match=0, mismatch=5, gap_o=6, gap_e=2, max_score=30)),
    ("swg", 48, dict(max_score=60, match=0, mismatch=7, gap_o=2, gap_e=3),
     dict(match=0, mismatch=7, gap_o=2, gap_e=3, max_score=60)),
    ("swg", 96, dict(max_score=200, match=-1, mismatch=2, gap_o=3, gap_e=1,
                     variant="hbm"),
     dict(match=-1, mismatch=2, gap_o=3, gap_e=1, max_score=200)),
    ("wfa", 48, dict(max_score=20, mismatch=2, gap_o=3, gap_e=2,
                     adaptive=False),
     dict(mismatch=2, gap_o=3, gap_e=2, max_score=20, adaptive=False)),
    ("wfa", 48, dict(max_score=14, mismatch=5, gap_o=2, gap_e=1,
                     adaptive=True),
     dict(mismatch=5, gap_o=2, gap_e=1, max_score=14, adaptive=True)),
    ("wfa", 96, dict(max_score=40, mismatch=3, gap_o=4, gap_e=1,
                     adaptive=True),
     dict(mismatch=3, gap_o=4, gap_e=1, max_score=40, adaptive=True)),
    ("wfa", 256, dict(max_score=100, mismatch=5, gap_o=2, gap_e=1,
                      adaptive=True, variant="hbm"),
     dict(mismatch=5, gap_o=2, gap_e=1, max_score=100, adaptive=True)),
    ("wfa", 256, dict(max_score=90, mismatch=2, gap_o=1, gap_e=3,
                      variant="hbm"),
     dict(mismatch=2, gap_o=1, gap_e=3, max_score=90, adaptive=False)),
    ("wfa", 1040, dict(max_score=110, mismatch=4, gap_o=3, gap_e=2,
                       adaptive=True, variant="hbm"),
     dict(mismatch=4, gap_o=3, gap_e=2, max_score=110, adaptive=True),
     256),
    ("genasm", 48, dict(max_score=12), dict(max_score=12)),
    ("genasm", 96, dict(max_score=20), dict(max_score=20)),
    # long reads under non-default cost models, incl. the cheap-gap
    # alias-chain regime
    ("nw", 2560, dict(max_score=300, gap_i=2, gap_d=5, mismatch=1,
                      variant="hbm"),
     dict(mismatch=1, gap_i=2, gap_d=5), 256),
    ("nw", 2560, dict(max_score=300, gap_i=1, gap_d=1, mismatch=4,
                      variant="hbm"),
     dict(mismatch=4, gap_i=1, gap_d=1), 256),
    ("swg", 2560, dict(max_score=400, match=0, mismatch=7, gap_o=2, gap_e=3,
                       variant="hbm"),
     dict(match=0, mismatch=7, gap_o=2, gap_e=3, max_score=400), 256),
    ("genasm", 2560, dict(max_score=60, variant="hbm"), dict(max_score=60),
     256),
    ("genasm", 2560, dict(max_score=252, variant="hbm"),
     dict(max_score=252), 256),
    # ---- >4-symbol alphabets: every tier compares raw bytes ----
    ("nw", 96, dict(max_score=24, gap_i=3, gap_d=2, mismatch=2,
                    variant="hbm"),
     dict(mismatch=2, gap_i=3, gap_d=2), 2048, "ACGTN"),
    ("swg", 48, dict(max_score=30, match=0, mismatch=5, gap_o=6, gap_e=2),
     dict(match=0, mismatch=5, gap_o=6, gap_e=2, max_score=30),
     2048, "ACGTN"),
    ("wfa", 200, dict(max_score=35, mismatch=4, gap_o=2, gap_e=2,
                      adaptive=True),
     dict(mismatch=4, gap_o=2, gap_e=2, max_score=35, adaptive=True),
     2048, "ACGTN"),
    ("genasm", 48, dict(max_score=12), dict(max_score=12), 2048, "ACGTN"),
]


def run_one(algo, R, kw, okw, seed, n=2048, alphabet="ACGT"):  # noqa: C901
    pairs = random_pairs(seed=seed, n=n, max_len=R - 8, balanced=False,
                         alphabet=alphabet)
    pats, txts, pl, tl = pack(pairs, R)
    cfg = AlignConfig(algo=algo, read_size=R, backtrace=True, **kw)
    res = align(pats, txts, pl, tl, cfg)
    if algo == "genasm":
        osc, oops, ob, oe = nat.genasm_align(pats, txts, pl, tl,
                                             backtrace=True, **okw)
    elif algo == "nw":
        osc, oops, ob, oe = nat.nw_align(pats, txts, pl, tl,
                                         backtrace=True, **okw)
    elif algo == "swg":
        osc, oops, ob, oe = nat.swg_align(pats, txts, pl, tl, backtrace=True,
                                          cell_width=cfg.cell_width, **okw)
    else:
        osc, oops, ob, oe = nat.wfa_align(pats, txts, pl, tl,
                                          backtrace=True, **okw)
    sbad = int((res.scores != osc).sum())
    cbad = sum(1 for i in range(n)
               if oops[i][ob[i]:oe[i]].tobytes() !=
               res.ops[i][res.begin[i]:res.end[i]].tobytes())
    print(f"{algo} R={R} {kw} alpha={len(set(alphabet))} seed={seed}: "
          f"fallback={res.n_fallback} score_bad={sbad} cigar_bad={cbad}",
          flush=True)
    if sbad or cbad:
        for i in range(n):
            if res.scores[i] != osc[i] or \
                    oops[i][ob[i]:oe[i]].tobytes() != \
                    res.ops[i][res.begin[i]:res.end[i]].tobytes():
                print("  FIRST BAD:", i, pairs[i], res.scores[i], osc[i])
                break
    return sbad + cbad


def main():
    seed0 = int(sys.argv[1]) if len(sys.argv) > 1 else 101
    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    bad = 0
    for cfg_row in CONFIGS:
        algo, R, kw, okw = cfg_row[:4]
        n = cfg_row[4] if len(cfg_row) > 4 else 2048
        alphabet = cfg_row[5] if len(cfg_row) > 5 else "ACGT"
        for s in range(seed0, seed0 + n_seeds):
            bad += run_one(algo, R, kw, okw, s, n=n, alphabet=alphabet)
    print("TOTAL BAD:", bad)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
