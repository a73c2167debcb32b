"""End-to-end CLI tests: file in -> reference-format file out, byte-identical
to the oracle pipeline."""

import re

import numpy as np
import pytest

import aim_tpu.native as nat
from aim_tpu.cli import main
from tests.util import random_pairs, write_pair_file


@pytest.fixture(scope="module")
def pair_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "pairs.txt"
    # l=20 e=0.05 -> READ_SIZE=32, MAX_SCORE=5
    pairs = random_pairs(seed=21, n=40, max_len=20)
    write_pair_file(path, pairs)
    return str(path)


def _oracle_out(tmp, algo, pair_file, n, cfg_kw, out_name):
    pats, txts, pl, tl = nat.parse_pairs(pair_file, n, cfg_kw["read_size"])
    if algo == "wfa":
        sc, ops, b, e = nat.wfa_align(pats, txts, pl, tl,
                                      mismatch=3, gap_o=4, gap_e=1,
                                      max_score=cfg_kw["max_score"],
                                      adaptive=cfg_kw.get("adaptive", False),
                                      backtrace=True)
    elif algo == "nw":
        sc, ops, b, e = nat.nw_align(pats, txts, pl, tl, mismatch=3,
                                     gap_i=4, gap_d=4, backtrace=True)
    else:
        sc, ops, b, e = nat.swg_align(pats, txts, pl, tl, match=0, mismatch=3,
                                      gap_o=4, gap_e=1,
                                      max_score=cfg_kw["max_score"],
                                      cell_width=1, backtrace=True)
    path = str(tmp / out_name)
    nat.emit_output(path, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    backtrace=True)
    return path


@pytest.mark.parametrize("algo,extra", [
    ("nw", []),
    ("swg", []),
    ("wfa", []),
    ("wfa", ["-r"]),
])
def test_cli_byte_identical(tmp_path, pair_file, algo, extra):
    out = str(tmp_path / f"{algo}.out")
    rc = main([algo, "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "40", "-b", "-q"] + extra)
    assert rc == 0
    from aim_tpu.cli import build_parser, config_from_args
    args = build_parser().parse_args(
        [algo, "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
         "-n", "40", "-b", "-q"] + extra)
    cfg = config_from_args(args)
    ref = _oracle_out(tmp_path, algo, pair_file, 40,
                      {"read_size": cfg.read_size, "max_score": cfg.max_score,
                       "adaptive": cfg.adaptive}, f"{algo}.ref")
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_cli_score_only(tmp_path, pair_file):
    out = str(tmp_path / "scores.out")
    rc = main(["wfa", "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "40", "-q"])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 40
    assert all(l.endswith(", ") for l in lines)  # "%d, %d, \n" format


def test_cli_rejects_bad_penalties(pair_file):
    with pytest.raises(SystemExit):
        main(["wfa", "-i", pair_file, "-o", "/tmp/x", "-l", "20", "-e",
              "0.05", "-n", "4", "-x", "0"])


def test_cli_tasklet_override_shrinks_batch(pair_file):
    """-t forces the per-device batch down (only down, like the
    reference's NR_TASKLETS override, run-wfa-pim-mram.py:106-112)."""
    from aim_tpu.cli import build_parser, config_from_args
    base = ["wfa", "-i", pair_file, "-o", "/dev/null", "-l", "20",
            "-e", "0.05", "-n", "40", "-q"]
    default = config_from_args(build_parser().parse_args(base))
    forced = config_from_args(build_parser().parse_args(base + ["-t", "2"]))
    assert forced.batch_pairs == 2048 < default.batch_pairs
    # out-of-range values are ignored, as in the reference
    too_big = config_from_args(
        build_parser().parse_args(base + ["-t", "999"]))
    assert too_big.batch_pairs == default.batch_pairs
    zero = config_from_args(build_parser().parse_args(base + ["-t", "0"]))
    assert zero.batch_pairs == default.batch_pairs


def test_cli_rejects_fewer_pairs_than_devices(tmp_path, pair_file, capsys):
    """ref: host.c:180-184 exits when total reads <= NR_DPUS."""
    out = str(tmp_path / "x.out")
    rc = main(["wfa", "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "4", "-b", "-q", "-d", "8"])
    assert rc == 1
    assert "Allocated DPUs more than needed" in capsys.readouterr().out


def test_memory_batch_cap_scales_with_budget():
    from aim_tpu.api import _device_memory_budget, _memory_batch_cap
    from aim_tpu.config import AlignConfig
    cfg = AlignConfig(algo="wfa", read_size=112, max_score=25)
    small = _memory_batch_cap(cfg, budget_bytes=1 << 20)
    big = _memory_batch_cap(cfg, budget_bytes=1 << 34)
    assert big > small
    assert _device_memory_budget() >= 1  # never zero, stats or fallback


def test_cli_energy_estimate(tmp_path, pair_file, capsys):
    out = str(tmp_path / "e.out")
    rc = main(["wfa", "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "40", "--energy",
               "--device-log", str(tmp_path / "dev.log")])
    assert rc == 0
    from aim_tpu.api import card_power_limits_w
    out = capsys.readouterr().out
    assert "Device kernel energy (J, estimated at the cards' power " \
        "limits):" in out
    log = open(tmp_path / "dev.log").read()
    assert "energy_est_J=" in log
    if not card_power_limits_w():
        # no wattage is assumed when the cards' limits cannot be read
        assert "not available" in out and "energy_est_J=n/a" in log


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_energy_estimate_sums_the_cards_used(tmp_path, pair_file, capsys,
                                             monkeypatch, ndev):
    """A run sharded over n cards is charged the power limits of those n
    cards; with fewer readable limits than cards no figure is given."""
    from aim_tpu import api
    limits = (700.0, 700.0, 400.0, 400.0)
    monkeypatch.setattr(api, "card_power_limits_w", lambda: limits)
    rc = main(["wfa", "-i", pair_file, "-o", str(tmp_path / "e.out"),
               "-l", "20", "-e", "0.05", "-n", "40", "-d", str(ndev),
               "--energy"])
    assert rc == 0
    out = capsys.readouterr().out
    t_kernel = float(re.search(r"^Device kernel: ([0-9.]+) ms", out,
                               re.M).group(1)) / 1e3
    joules = float(re.search(r"^Device kernel energy .*: ([0-9.]+)$", out,
                             re.M).group(1))
    assert joules == pytest.approx(t_kernel * sum(limits[:ndev]),
                                   rel=1e-3, abs=1e-5)
    assert api.energy_estimate_joules(
        api.AlignResult(np.zeros(1, np.int32), t_kernel=2.0,
                        n_devices=ndev)) == 2.0 * sum(limits[:ndev])
    assert api.energy_estimate_joules(
        api.AlignResult(np.zeros(1, np.int32), t_kernel=2.0,
                        n_devices=5)) is None


@pytest.mark.slow
def test_cli_profile_trace(tmp_path, pair_file):
    """--profile must produce a jax.profiler trace dir (SURVEY §5.1: the
    reference's timing/energy probes -> TensorBoard-loadable traces).
    Slow-gated: trace collection takes tens of seconds on the CPU."""
    import os
    out = str(tmp_path / "p.out")
    prof = str(tmp_path / "trace")
    rc = main(["wfa", "-i", pair_file, "-o", out, "-l", "20", "-e", "0.05",
               "-n", "40", "-q", "--profile", prof])
    assert rc == 0
    found = [os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs]
    assert found, "profiler trace directory is empty"


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir_rule(env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise a fixed path in
    the checkout (the path is part of the cache key)."""
    import os
    import jax
    from aim_tpu.api import compile_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env == "set":
        assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR":
                                  str(tmp_path)}) == str(tmp_path)
    else:
        assert compile_cache_dir({}) == os.path.join(repo, ".jax_cache")
    # this process follows the same rule
    assert jax.config.jax_compilation_cache_dir == compile_cache_dir()
