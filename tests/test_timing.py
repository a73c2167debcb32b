"""Structural timing honesty (tools/_timing.py): ~0 ms anchors must be
rejected, and the interleaved A/B protocol must alternate arms in one
process."""

import sys
import time

import numpy as np
import pytest

sys.path.insert(0, ".")

from tools import _timing as T  # noqa: E402


def test_best_of_rejects_zero_anchor():
    with pytest.raises(T.SuspectTimingError):
        T.best_of(lambda: None, repeats=2, block=False)


def test_best_of_host_optout_and_value():
    t = T.best_of(lambda: time.sleep(0.002), repeats=2, block=False,
                  min_anchor_s=0)
    assert 0.001 < t < 0.5


def test_best_of_blocks_on_device_values():
    # a real jax value exercises the default block path end-to-end
    import jax
    x = np.arange(256, dtype=np.int32)
    t = T.best_of(lambda: jax.numpy.cumsum(jax.device_put(x)),
                  repeats=2, min_anchor_s=0)
    assert t >= 0


def test_interleaved_ab_alternates():
    order = []

    def a():
        order.append("a")
        time.sleep(0.002)
        return np.zeros(1)

    def b():
        order.append("b")
        time.sleep(0.002)
        return np.zeros(1)

    ba, bb, ta, tb = T.interleaved_ab(a, b, rounds=3, min_anchor_s=1e-4)
    # warmup a,b then strict a/b alternation
    assert order == ["a", "b"] + ["a", "b"] * 3
    assert len(ta) == len(tb) == 3
    assert ba > 0 and bb > 0


def test_interleaved_ab_rejects_zero_anchor():
    z = np.zeros(1)
    with pytest.raises(T.SuspectTimingError):
        T.interleaved_ab(lambda: z, lambda: z, rounds=2)
