"""Shared helpers for the batch DP kernels."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def min_plus_scan(z: jnp.ndarray, slope: int) -> jnp.ndarray:
    """Min-plus prefix scan along the last axis:

        out[v] = min_{j <= v} ( z[j] + (v - j) * slope )

    This closed form linearizes the reference's sequential deletion chain
    ``cell[v] = min(indep[v], cell[v-1] + gap)`` (ref: NW/DPU-WRAM/dpu/nw.c:139,
    SWG/DPU-WRAM/dpu/swg.c:151-153): substituting the recurrence yields
    exactly this min-plus convolution, with identical integer results (min
    and + commute associatively; no reassociation error).  Subtracting the
    ramp turns it into a plain cumulative minimum.
    """
    ramp = jax.lax.broadcasted_iota(jnp.int32, z.shape, z.ndim - 1) * slope
    return jax.lax.cummin(z - ramp, axis=z.ndim - 1) + ramp


def shift_right_lanes(x: jnp.ndarray, fill) -> jnp.ndarray:
    """out[..., v] = x[..., v-1]; out[..., 0] = fill."""
    rolled = jnp.roll(x, 1, axis=-1)
    pos = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    return jnp.where(pos >= 1, rolled, fill)


def gather_lane(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Per-row lane gather: out[n] = x[n, idx[n]] for 2-D x."""
    return jnp.take_along_axis(x, idx[:, None], axis=1)[:, 0]
