"""Shared timing helpers with structural honesty guards.

1. A ~0 timing anchor is evidence of a timing that returned before the
   device finished (an unblocked asynchronous dispatch), not of a fast
   kernel: every device-side measurement rejects anchors below
   `min_anchor_s` (default 1 ms) by raising `SuspectTimingError`.
2. Decisions between two variants come from interleaved A/B in ONE
   process on one card (`interleaved_ab`), never from two separate runs
   whose cards, clocks and neighbours may differ.
"""

from __future__ import annotations

import time


class SuspectTimingError(RuntimeError):
    """A device timing anchor came back implausibly small — the classic
    signature of an asynchronous dispatch timed without blocking."""


def best_of(thunk, repeats: int = 3, *, min_anchor_s: float = 1e-3,
            block=None, warmup: bool = True) -> float:
    """Best wall-clock seconds of `thunk()` over `repeats` runs.

    `thunk` must return the value to block on (or None if it blocks
    itself); pass `block=False` to skip blocking, or a callable to
    block a custom way.  Host-only timings can pass `min_anchor_s=0`
    to disable the anchor guard — device timings must not.
    """
    do_block = block
    if do_block is None:
        import jax
        do_block = jax.block_until_ready
    if warmup:
        out = thunk()
        if do_block:
            do_block(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = thunk()
        if do_block:
            do_block(out)
        best = min(best, time.perf_counter() - t0)
    if best < min_anchor_s:
        raise SuspectTimingError(
            f"timing anchor {best * 1e3:.3f} ms < {min_anchor_s * 1e3:.1f} ms"
            " — an unblocked asynchronous dispatch? (pass min_anchor_s=0"
            " only for host-side timings)")
    return best


def marginal_us(timed, n_small: int, n_large: int) -> float:
    """Two-point batch-scaling slope in us/item: `timed(m)` must return
    best-of seconds for a batch of m (use `best_of` inside)."""
    t1 = timed(n_small)
    t2 = timed(n_large)
    return (t2 - t1) / (n_large - n_small) * 1e6


def interleaved_ab(thunk_a, thunk_b, rounds: int = 5, *,
                   min_anchor_s: float = 1e-3):
    """The variant-decision protocol: alternate A and B within one
    process so clock and thermal drift hit both arms equally.  Returns
    (best_a, best_b, times_a, times_b)."""
    import jax
    # warm both arms (compile + first-dispatch cost outside the timings)
    jax.block_until_ready(thunk_a())
    jax.block_until_ready(thunk_b())
    ta, tb = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(thunk_a())
        ta.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(thunk_b())
        tb.append(time.perf_counter() - t0)
    best_a, best_b = min(ta), min(tb)
    if min(best_a, best_b) < min_anchor_s:
        raise SuspectTimingError(
            f"interleaved anchors {best_a * 1e3:.3f}/{best_b * 1e3:.3f} ms"
            " below the validity floor")
    return best_a, best_b, ta, tb
