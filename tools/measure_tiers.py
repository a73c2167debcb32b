"""On-card measurements of the device tiers (PERF.md).

1. The device batch size (cfg.batch_pairs) at the headline config: each
   arm is api.align over the same aim_tpu.datagen pairs, arms alternate
   in one process (A B B A ...), warm-up excluded.
2. With --trace DIR: one profiled align_file per smoke phase config, each
   reduced to device busy/idle share and top operations
   (tools/trace_top_ops.py).

    python tools/measure_tiers.py [--small] [--rounds N] [--trace DIR]

--small runs every arm once at toy sizes (a compile check).  Prints one
JSON object per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from aim_tpu import api  # noqa: E402
from aim_tpu.config import derive_config  # noqa: E402
from aim_tpu.datagen import generate_pairs, write_pair_file  # noqa: E402


def alternate(name, arms, n, rounds, extra=None):
    """Warm every arm, then time them in alternating order."""
    for thunk in arms.values():
        thunk()
    times = {k: [] for k in arms}
    labels = list(arms)
    for r in range(rounds):
        for k in (labels if r % 2 == 0 else labels[::-1]):
            t0 = time.perf_counter()
            arms[k]()
            times[k].append(time.perf_counter() - t0)
    rec = {"measurement": name, "pairs": n, "rounds": rounds}
    for k, ts in times.items():
        rec[k] = {"median_s": statistics.median(ts), "min_s": min(ts),
                  "times_s": ts,
                  "pairs_per_s_median": n / statistics.median(ts)}
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)


def batch_sizes(n, sizes, rounds):
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    arrays = generate_pairs(n, 100, 0.01, cfg.read_size, seed=4)
    arms = {f"batch_{b}": (lambda b=b: api.align(
        *arrays, cfg.replace(batch_pairs=b))) for b in sizes}
    alternate("batch_pairs wfa-adaptive 100bp bt", arms, n, rounds,
              {"memory_cap_pairs": api._memory_batch_cap(cfg)})


PHASES = [  # (name, algo, length, pairs, flags)
    ("a", "wfa", 100, 262_144, ["-b", "-r"]),
    ("b", "nw", 100, 131_072, ["-b"]),
    ("b", "swg", 100, 131_072, ["-b"]),
    ("b", "genasm", 100, 131_072, ["-b"]),
    ("c", "wfa", 10_000, 512, ["--variant", "hbm", "-b", "-r"]),
    ("c", "nw", 1000, 2000, ["--variant", "hbm", "-b"]),
    ("c", "swg", 1000, 2000, ["--variant", "hbm", "-b"]),
]


def trace_phases(root, small):
    """One warm, then one profiled align_file per phase config."""
    from aim_tpu.cli import build_parser, config_from_args
    from tools.trace_top_ops import reduce_trace
    import glob
    with tempfile.TemporaryDirectory() as work:
        for name, algo, length, n, flags in PHASES:
            if small:
                n = min(n, 2048 if length == 100 else 8)
            inp = os.path.join(work, f"{algo}{length}.txt")
            write_pair_file(inp, n, length, 0.01, seed=9)
            out = os.path.join(work, "out")
            argv = [algo, "-i", inp, "-o", out, "-l", str(length), "-e",
                    "0.01", "-n", str(n), "-q"] + flags
            cfg = config_from_args(build_parser().parse_args(argv))
            api.align_file(inp, out, n, cfg, verbose=False)
            tdir = os.path.join(root, f"{name}-{algo}-{length}")
            t0 = time.perf_counter()
            res = api.align_file(inp, out, n, cfg, verbose=False,
                                 profile_dir=tdir)
            wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            api.align_file(inp, out, n, cfg, verbose=False)
            wall_plain = time.perf_counter() - t1
            rec = {"phase": name, "algo": algo, "length": length,
                   "pairs": n, "wall_s_profiled": wall,
                   "wall_s": wall_plain, "pairs_per_s": n / wall_plain,
                   "t_load_s": res.t_load, "t_kernel_s": res.t_kernel,
                   "t_retrieve_s": res.t_retrieve,
                   "host_fallback": res.n_fallback}
            for p in glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                               recursive=True):
                r = reduce_trace(p)
                for d in r["devices"].values():
                    d.pop("lines", None)
                rec["trace"] = r
            print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    devs = jax.devices()
    print(json.dumps({"device": {"platform": devs[0].platform,
                                 "kind": devs[0].device_kind,
                                 "count": len(devs)}}), flush=True)
    rounds = 1 if args.small else args.rounds
    if args.small:
        batch_sizes(4096, (1024, 2048), 1)
    else:
        batch_sizes(1_048_576, (16_384, 65_536, 262_144), rounds)
    if args.trace:
        trace_phases(args.trace, args.small)


if __name__ == "__main__":
    main()
