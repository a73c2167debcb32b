"""Multi-device pair sharding on the virtual 8-device CPU mesh."""

import os

import jax
import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig
from aim_tpu.parallel import make_mesh, pair_sharding
from tests.test_kernels_xla import ALGOS, assert_matches_oracle
from tests.util import cigar_of, pack, random_pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_wfa_matches_oracle():
    R = 24
    pairs = random_pairs(seed=31, n=64, max_len=R)
    pats, txts, pl, tl = pack(pairs, R)
    cfg = AlignConfig(algo="wfa", read_size=R, max_score=12, backtrace=True,
                      adaptive=True, batch_pairs=64)
    from aim_tpu.api import align
    sharding = pair_sharding(make_mesh())
    res = align(pats, txts, pl, tl, cfg, device_sharding=sharding)
    osc, oops, ob, oe = nat.wfa_align(pats, txts, pl, tl, mismatch=3,
                                      gap_o=4, gap_e=1, max_score=12,
                                      adaptive=True, backtrace=True)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(len(pairs)):
        assert cigar_of(res.ops[i], res.begin[i], res.end[i]) == \
            cigar_of(oops[i], ob[i], oe[i])


def test_multihost_runner_single_process(tmp_path):
    from aim_tpu.parallel.runner import align_file_multihost
    from tests.util import write_pair_file
    pairs = random_pairs(seed=41, n=24, max_len=20)
    inp = str(tmp_path / "pairs.txt")
    write_pair_file(inp, pairs)
    out = str(tmp_path / "out.txt")
    cfg = AlignConfig(algo="wfa", read_size=32, max_score=8, backtrace=True)
    n, res = align_file_multihost(inp, out, 24, cfg, verbose=False)
    assert n == 24
    lines = open(out).read().splitlines()
    assert len(lines) == 48 and lines[0].startswith("0, ")


def test_multihost_runner_two_processes(tmp_path):
    """The real multi-process path (ref sharding semantics, host.c:191-268):
    two concurrent OS processes each align a contiguous pair block and write
    an atomic part file; process 0 performs the ordered concatenation.
    Output must be byte-identical to a single-process run."""
    import subprocess
    import sys

    from aim_tpu.parallel.runner import align_file_multihost
    from tests.util import write_pair_file

    pairs = random_pairs(seed=43, n=30, max_len=20)
    inp = str(tmp_path / "pairs.txt")
    write_pair_file(inp, pairs)
    ref_out = str(tmp_path / "ref.txt")
    cfg = AlignConfig(algo="wfa", read_size=32, max_score=8, backtrace=True)
    align_file_multihost(inp, ref_out, 30, cfg, verbose=False)

    out = str(tmp_path / "out.txt")
    script = (
        "import sys\n"
        "from aim_tpu.config import AlignConfig\n"
        "from aim_tpu.parallel.runner import align_file_multihost\n"
        "cfg = AlignConfig(algo='wfa', read_size=32, max_score=8,\n"
        "                  backtrace=True)\n"
        "align_file_multihost(sys.argv[1], sys.argv[2], 30, cfg,\n"
        "                     process_id=int(sys.argv[3]), n_processes=2,\n"
        "                     verbose=False)\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, inp, out,
                               str(p)], cwd=REPO)
             for p in (0, 1)]
    for pr in procs:
        assert pr.wait(timeout=300) == 0
    assert open(out, "rb").read() == open(ref_out, "rb").read()
    # parts were consumed by the concatenation
    assert not os.path.exists(out + ".part0")
    assert not os.path.exists(out + ".part1")


def test_shard_range_covers_and_preserves_order():
    from aim_tpu.parallel.mesh import shard_range
    total = 1003
    covered = []
    for h in range(4):
        lo, hi = shard_range(total, h, 4)
        covered.extend(range(lo, hi))
    assert covered == list(range(total))


@pytest.mark.parametrize("backtrace", [True, False])
@pytest.mark.parametrize("name", ["genasm", "nw", "swg"])
def test_sharded_matches_oracle(name, backtrace):
    """The CLI's default multi-device path: the batch split over the
    8-device 'pairs' mesh, one jit program (SPMD)."""
    from aim_tpu.api import align
    pairs = random_pairs(seed=97, n=128, max_len=28)
    pats, txts, pl, tl = pack(pairs, 32)
    cfg = AlignConfig(read_size=32, backtrace=backtrace, batch_pairs=64,
                      **ALGOS[name])
    res = align(pats, txts, pl, tl, cfg,
                device_sharding=pair_sharding(make_mesh()))
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)
