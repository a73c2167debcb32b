"""Reduce a jax.profiler trace to device metrics: busy and idle share of
the traced window, and the operations that took the device's time.

    python tools/trace_top_ops.py <profile_dir> [top_n]

Reads every `*.xplane.pb` under profile_dir.  Device planes are those
named `/device:GPU:<i>`; their kernel events sit on per-stream lines.
Busy time is the union of those events' intervals; the window runs from
the first to the last event on any plane (host spans included), so the
idle share counts time the host kept the device waiting.  Prints one
JSON object per trace file.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, top_n: int = 12) -> dict:
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    t_lo, t_hi = None, None
    devices = {}
    for plane in pd.planes:
        is_dev = plane.name.startswith("/device:GPU")
        ops = defaultdict(float)
        iv = []
        lines = []
        for line in plane.lines:
            for ev in line.events:
                s, d = ev.start_ns, ev.duration_ns
                t_lo = s if t_lo is None else min(t_lo, s)
                t_hi = s + d if t_hi is None else max(t_hi, s + d)
                if is_dev and line.name.startswith("Stream"):
                    ops[ev.name] += d
                    iv.append((s, s + d))
            lines.append(line.name)
        if is_dev:
            devices[plane.name] = (ops, _union_ns(iv), lines)
    window = (t_hi - t_lo) if t_lo is not None else 0
    out = {"trace": path, "window_s": window / 1e9, "devices": {}}
    for name, (ops, busy, lines) in devices.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:top_n]
        out["devices"][name] = {
            "busy_s": busy / 1e9,
            "idle_share": 1 - busy / window if window else None,
            "kernel_s": sum(ops.values()) / 1e9,
            "top_ops_s": [[k, v / 1e9] for k, v in top],
            "lines": lines,
        }
    return out


def main():
    root = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    paths = sorted(glob.glob(os.path.join(root, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise SystemExit(f"no trace under {root}")
    for p in paths:
        print(json.dumps(reduce_trace(p, top_n)))


if __name__ == "__main__":
    main()
