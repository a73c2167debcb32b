"""Benchmark: WFA-adaptive pairs/s on one card for the canonical AIM
workload (100 bp, e=1%, backtrace on).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "pairs/s", "vs_baseline": N,
   "device": {"platform", "kind", "count", "name_power_limit"}, ...}

value is the end-to-end align() rate (transfers + kernel + host
traceback) over 200,000 pairs from aim_tpu.datagen (fixed seed);
vs_baseline divides it by the single-thread host oracle's rate on the
same pairs, mirroring the reference's "speedup vs CPU including transfer
time" framing (README.md:11-12).  cpu_mt_pairs_s is the full-pool oracle.

The parent process never touches the device: the measurement runs in one
child (`bench.py --measure`) under a hard wall-clock budget
(AIM_TPU_BENCH_BUDGET seconds), checkpointing each finished metric, so a
hung or failed child still yields a JSON line (marked degraded, or an
explicit error).  A run without a GPU is an error, never a CPU number.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tools import _timing as T  # noqa: E402

N_PAIRS = 200_000
SEED = 0
_REPO = os.path.dirname(os.path.abspath(__file__))

MEASURE_BUDGET = float(os.environ.get("AIM_TPU_BENCH_BUDGET", "600"))
# Test-only hook: replaces the child command so the guard test can
# exercise the real wall-clock kill path with a hanging child.
_TEST_CHILD = os.environ.get("AIM_TPU_BENCH_TEST_CHILD_CMD")

_HEADLINE = "WFA-adaptive pairs aligned/s/card (100bp, e=1%, backtrace)"


def measure(partial_path: str):
    """Measurement child: all device work lives here.  Checkpoints every
    completed metric to partial_path (atomic replace) so the parent can
    emit a degraded-but-real JSON line if this process is killed."""
    import jax
    import aim_tpu.native as nat
    from aim_tpu.api import align
    from aim_tpu.config import derive_config
    from aim_tpu.datagen import generate_pairs

    part = {"metric": _HEADLINE, "value": 0.0, "unit": "pairs/s",
            "vs_baseline": 0.0, "host_cpu_cores": os.cpu_count()}

    def save():
        tmp = partial_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(part))
        os.replace(tmp, partial_path)

    devs = jax.devices()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    part["device"] = {"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs),
                      "name_power_limit": smi.stdout.strip().splitlines()}
    save()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")

    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    pats, txts, plens, tlens = generate_pairs(N_PAIRS, 100, 0.01,
                                              cfg.read_size, seed=SEED)
    n = len(plens)

    # CPU denominators first (device-independent).  Best of 3.
    def cpu_rate(threads, m):
        best = T.best_of(
            lambda: nat.wfa_align(
                pats[:m], txts[:m], plens[:m], tlens[:m],
                mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                gap_e=cfg.gap_e, max_score=cfg.max_score,
                adaptive=True, backtrace=True, threads=threads),
            repeats=3, block=False, warmup=False, min_anchor_s=0)
        return m / best

    cpu_1t = cpu_rate(1, 20_000)
    cpu_mt = cpu_rate(0, n)
    part["cpu_1t_pairs_s"] = round(cpu_1t, 1)
    part["cpu_mt_pairs_s"] = round(cpu_mt, 1)
    save()

    align(pats, txts, plens, tlens, cfg)  # compile + warm
    t_dev = T.best_of(lambda: align(pats, txts, plens, tlens, cfg),
                      repeats=3, block=False, warmup=False)
    res = align(pats, txts, plens, tlens, cfg)
    rate = n / t_dev
    part["value"] = round(rate, 1)
    part["vs_baseline"] = round(rate / cpu_1t, 3)
    part["vs_cpu_mt_e2e"] = round(rate / cpu_mt, 3)
    part["split_s"] = {"load": round(res.t_load, 4),
                       "kernel": round(res.t_kernel, 4),
                       "retrieve": round(res.t_retrieve, 4)}
    part["host_fallback"] = res.n_fallback
    save()
    print(json.dumps(part))


def _emit_from_partial(partial_path: str, why: str):
    """Parent-side fallback: emit whatever the failed child managed to
    measure, marked degraded — or an explicit error object."""
    part = None
    try:
        with open(partial_path) as f:
            part = json.loads(f.read())
    except (OSError, ValueError):
        part = None
    if part and part.get("value", 0) > 0:
        part["degraded"] = True
        part["error"] = why
        print(json.dumps(part))
    else:
        print(json.dumps({
            "metric": _HEADLINE, "value": 0.0, "unit": "pairs/s",
            "vs_baseline": 0.0,
            "error": f"measurement failed ({why}); partial metrics: "
                     f"{json.dumps(part) if part else 'none'}",
        }))


def main():
    budget = MEASURE_BUDGET
    fd, partial_path = tempfile.mkstemp(prefix="aim_bench_", suffix=".json")
    os.close(fd)
    cmd = ([sys.executable, os.path.abspath(__file__), "--measure",
            partial_path] if not _TEST_CHILD else _TEST_CHILD.split())
    # Small grace on top of the budget so a child that is mid-save still
    # finishes cleanly; scaled down for tiny test budgets.
    grace = min(30.0, budget * 0.1 + 5.0)
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=budget + grace, cwd=_REPO)
        sys.stderr.write(r.stderr)
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        if r.returncode == 0 and lines:
            print(lines[-1])
        else:
            _emit_from_partial(
                partial_path,
                f"measure child rc={r.returncode}, no JSON; stderr tail: "
                f"{r.stderr.strip()[-300:]}")
    except subprocess.TimeoutExpired as e:
        if e.stderr:
            sys.stderr.write(e.stderr if isinstance(e.stderr, str)
                             else e.stderr.decode(errors="replace"))
        _emit_from_partial(
            partial_path,
            f"measure child exceeded {budget + grace:g}s budget")
    finally:
        try:
            os.unlink(partial_path)
        except OSError:
            pass


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
    else:
        main()
