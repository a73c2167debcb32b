"""bench.py's liveness contract: the JSON line is emitted within a hard
wall-clock budget no matter what the measurement child does.  The parent
process never touches the device; the one measurement child checkpoints
partial results, so a hung or failed child produces either a
degraded-but-real JSON line or an explicit error line — never silence."""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest


def _load_bench():
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("bench_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_emits_error_json_when_relay_down(monkeypatch, capsys):
    # The measurement child hangs past its timeout having measured
    # nothing: the parent must still emit an explicit error object.
    bench = _load_bench()

    def timeout_run(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=kw.get("timeout"))

    monkeypatch.setattr(bench.subprocess, "run", timeout_run)
    bench.main()
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["unit"] == "pairs/s"
    assert rec["value"] == 0.0
    assert "measurement failed" in rec["error"]


def test_bench_emits_degraded_partial_when_child_killed(monkeypatch,
                                                        capsys):
    # The measurement child got real numbers checkpointed before it
    # stalled: the parent must emit them, marked degraded.
    bench = _load_bench()

    def fake_run(cmd, **kw):
        assert "--measure" in cmd
        partial = cmd[cmd.index("--measure") + 1]
        with open(partial, "w") as f:
            f.write(json.dumps({
                "metric": bench._HEADLINE, "value": 123456.0,
                "unit": "pairs/s", "vs_baseline": 0.03,
                "cpu_1t_pairs_s": 4e6}))
        raise subprocess.TimeoutExpired(cmd=cmd, timeout=kw.get("timeout"))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench.main()
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["value"] == 123456.0
    assert rec["degraded"] is True
    assert "budget" in rec["error"]


def test_bench_passes_through_child_json(monkeypatch, capsys):
    # Healthy path: the one measurement child's JSON line is relayed
    # verbatim, and no other child is started.
    bench = _load_bench()
    payload = {"metric": bench._HEADLINE, "value": 99.0, "unit": "pairs/s",
               "vs_baseline": 1.0,
               "device": {"platform": "gpu", "kind": "H100", "count": 1}}
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)

        class R:
            returncode = 0
            stdout = json.dumps(payload) + "\n"
            stderr = ""
        return R()

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench.main()
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][-1]
    assert json.loads(line) == payload
    assert len(calls) == 1 and "--measure" in calls[0]


@pytest.mark.parametrize("budget", ["2"])
def test_bench_wall_clock_bounded_with_hanging_children(budget):
    # REAL wall-clock: the child replaced by a hanging sleep via the test
    # hook; the whole bench.py invocation must finish well inside the
    # budget plus grace and still print a parseable error line.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update(AIM_TPU_BENCH_BUDGET=budget,
               AIM_TPU_BENCH_TEST_CHILD_CMD="sleep 600")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(repo, "bench.py")],
                       env=env, capture_output=True, text=True, timeout=60)
    wall = time.perf_counter() - t0
    assert wall < 30, f"bench.py took {wall:.1f}s with hanging children"
    lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    assert lines, r.stderr[-500:]
    rec = json.loads(lines[-1])
    assert rec["value"] == 0.0 and "error" in rec
