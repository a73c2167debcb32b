"""On-card smoke run of the aligner's served path (NVIDIA GPU).

Drives the user entry point `python -m aim_tpu.cli {wfa,nw,swg,genasm}`
in-process (cli.main -> api.align_file -> api.align) at the sizes users
run, and compares every output file byte for byte with the exact host
oracle's (the recipe of tests/test_cli.py::_oracle_out).  Every phase
prints its pairs, wall seconds, pairs/s, the host-to-device / kernel /
device-to-host split and its host-fallback count.

    python chip_smoke.py           # phases a-e on the first card
    python chip_smoke.py --four    # phase a sharded over four cards

Phases: (a) WFA-adaptive with backtrace, 100 bp, e=1%, 1,000,000 pairs;
(b) NW, SWG and GenASM with backtrace, 100 bp, 200,000 pairs each;
(c) the long-read tier: WFA-adaptive at 10 kbp (512 pairs), NW and SWG
at 1 kbp (2,000 pairs each); (d) all four algorithms on the in-repo real
sample; (e) the gpu-marked tests.  Input comes from aim_tpu.datagen with
a fixed seed.  Exits nonzero, printing no result, when JAX finds no GPU
or any phase fails.  The last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
SEED = 20231  # input data seed


def _run_cli(argv, n):
    """One CLI run: returns the phase numbers it printed, plus wall time."""
    from aim_tpu.cli import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}:\n{text}")

    def num(label):
        m = re.search(rf"^{re.escape(label)}: ([0-9.]+)", text, re.M)
        if m is None:
            raise RuntimeError(f"cli printed no {label!r} line:\n{text}")
        return float(m.group(1))

    return {"pairs": n, "wall_s": wall, "pairs_per_s": n / wall,
            "t_load_s": num("Host-to-device") / 1e3,
            "t_kernel_s": num("Device kernel") / 1e3,
            "t_retrieve_s": num("Device-to-host") / 1e3,
            "host_fallback": int(num("host-oracle fallback pairs"))}


def _oracle_file(argv, n, path):
    """The exact host oracle's output for the same pairs and config."""
    import numpy as np
    from aim_tpu import native
    from aim_tpu.api import _oracle_align
    from aim_tpu.cli import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(argv))
    pats, txts, pl, tl = native.parse_pairs(argv[argv.index("-i") + 1], n,
                                            cfg.read_size, threads=0)
    sc, ops, b, e = _oracle_align(pats, txts, pl, tl, cfg)
    native.emit_output(path, np.arange(len(sc), dtype=np.int32), sc, ops,
                       b, e, cfg.backtrace)


def phase(name, algo, flags, inp, n, length, error, work, *,
          expect_no_fallback=False):
    """Warm (compile) on the first batch, time the whole file, compare."""
    from aim_tpu.cli import build_parser, config_from_args
    out = os.path.join(work, f"{name}-{algo}.out")
    ref = os.path.join(work, f"{name}-{algo}.ref")
    base = [algo, "-i", inp, "-o", out, "-l", str(length), "-e", str(error)]
    argv = base + ["-n", str(n)] + flags
    # the first batch compiles the same program the whole run uses
    first = min(n, config_from_args(build_parser().parse_args(argv))
                .batch_pairs)
    t0 = time.perf_counter()
    _run_cli(base + ["-n", str(first)] + flags, first)
    warm = time.perf_counter() - t0
    r = _run_cli(argv, n)
    _oracle_file(argv, n, ref)
    with open(out, "rb") as f1, open(ref, "rb") as f2:
        same = f1.read() == f2.read()
    print(f"phase {name} {algo} {' '.join(flags)}: pairs={n} "
          f"wall_s={r['wall_s']:.3f} pairs/s={r['pairs_per_s']:.1f} "
          f"t_load_s={r['t_load_s']:.4f} t_kernel_s={r['t_kernel_s']:.4f} "
          f"t_retrieve_s={r['t_retrieve_s']:.4f} "
          f"host_fallback={r['host_fallback']} warm_s={warm:.1f} "
          f"byte_identical={same}", flush=True)
    if not same:
        raise RuntimeError(f"phase {name} {algo}: output differs from "
                           "the oracle's")
    if expect_no_fallback and r["host_fallback"]:
        raise RuntimeError(f"phase {name} {algo}: {r['host_fallback']} "
                           "pairs fell back to the host oracle")
    os.remove(out)
    os.remove(ref)


def gpu_tests():
    """Phase e: the gpu-marked tests, in this process (it holds the
    card).  Fails unless they all pass and at least one ran."""
    import pytest

    class Count:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1

    rc = pytest.main([os.path.join(REPO, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider"], plugins=[Count()])
    print(f"phase e gpu tests: passed={Count.passed} failed={Count.failed} "
          f"rc={int(rc)}", flush=True)
    if rc != 0 or Count.passed == 0 or Count.failed:
        raise RuntimeError("gpu-marked tests failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run phase a only, sharded over four cards")
    args = ap.parse_args()

    import jax
    from aim_tpu.datagen import write_pair_file
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform}", file=sys.stderr)
        return 2
    if args.four and len(devs) != 4:
        print(f"--four needs 4 cards, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line)
    print(f"jax {jax.__version__}, {len(devs)} device(s): "
          f"{devs[0].device_kind}", flush=True)

    # one card: pin the run to it (-d 1); four: the CLI's default mesh
    ndev = [] if args.four else ["-d", "1"]
    with tempfile.TemporaryDirectory() as work:
        short = os.path.join(work, "l100.txt")
        t0 = time.perf_counter()
        write_pair_file(short, 1_000_000, 100, 0.01, seed=SEED)
        print(f"generated 1,000,000 pairs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        # the launcher configs (a, b) must serve every pair on device
        phase("a", "wfa", ["-b", "-r"] + ndev, short, 1_000_000, 100, 0.01,
              work, expect_no_fallback=True)
        if not args.four:
            for algo in ("nw", "swg", "genasm"):
                phase("b", algo, ["-b"] + ndev, short, 200_000, 100, 0.01,
                      work, expect_no_fallback=True)
            w10k = os.path.join(work, "l10000.txt")
            write_pair_file(w10k, 512, 10_000, 0.01, seed=SEED)
            phase("c", "wfa", ["--variant", "hbm", "-b", "-r"] + ndev, w10k,
                  512, 10_000, 0.01, work)
            l1k = os.path.join(work, "l1000.txt")
            write_pair_file(l1k, 2000, 1000, 0.01, seed=SEED)
            for algo in ("nw", "swg"):
                phase("c", algo, ["--variant", "hbm", "-b"] + ndev, l1k,
                      2000, 1000, 0.01, work)
            for algo, flags in (("wfa", ["-b", "-r"]), ("nw", ["-b"]),
                                ("swg", ["-b"]), ("genasm", ["-b"])):
                phase("d", algo, flags + ndev, SAMPLE, 1000, 100, 0.01,
                      work)
    if not args.four:
        gpu_tests()
    # the cards the phases ran on: one (-d 1), or all four
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs) if args.four else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
