"""NW edit-distance kernel — pure-XLA batch implementation.

Vectorization: one lane per DP column v (pattern position), one batch row
per pair; rows of the DP table are produced sequentially by a ``lax.scan``
over text positions h.  The reference's in-row deletion chain is linearized
with a min-plus prefix scan (see ops.common.min_plus_scan).

Exact reference semantics (ref: NW/DPU-WRAM/dpu/nw.c:109-153):
  * the reference stores the table in a flat buffer ``dp[(tlen+1)*h + v]``
    with v ranging to plen, which for plen == tlen+1 aliases each row's
    column-plen slot onto the NEXT row's column-0 slot.  Equivalent clean
    formulation (derived by tracking last-writer order on the tape):
    column 0 of row h>=2 holds cell(h-1, plen), row 1's column 0 and row 0's
    column plen hold GAP_I.  Implemented here as the "boundary chain".
  * pairs with plen > tlen+1 alias across multiple columns and are flagged
    (``needs_fallback``) for the native exact-tape oracle; they do not occur
    in length-balanced datasets.
  * cells are int16 (NW_W16); we compute in int32 and flag pairs whose
    cells would exceed int16 (where the reference wraps) for the fallback.

Direction bits (when cfg.backtrace): uint8 per cell with the traceback
tie-break priority D -> I -> diag / X-iff-equality baked in
(ref: nw.c:76-94); walked on host by native.nw_traceback_bits.

GenASM mode (cfg.algo == "genasm"): this framework's GenASM is clean
bounded Levenshtein distance whose CIGAR is the NW walker's at unit costs
(golden/genasm.py), so the same kernel serves it with
  * mismatch = gap_i = gap_d = 1, whatever the config's cost fields say;
  * no tape aliasing (a proper 2-D table: nothing is flagged);
  * half-empty pairs scored plen + tlen (the tlen == 0 row-0 cell);
  * distances above MAX_SCORE reported as MAX_SCORE + 1 (the caller
    emits the default one-op CIGAR for those, as the host oracle does).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from aim_tpu.config import ALGO_GENASM, AlignConfig
from aim_tpu.ops.common import gather_lane, min_plus_scan, shift_right_lanes

I32 = jnp.int32
INT16_MAX = 32767


@functools.partial(jax.jit, static_argnames=("cfg",))
def nw_forward(pats, txts, plens, tlens, *, cfg: AlignConfig):
    """Batch NW forward (+ optional direction bits).

    Args:
      pats, txts: [n, R] uint8 (zero-padded).
      plens, tlens: [n] int32.
    Returns dict with:
      scores: [n] int32
      needs_fallback: [n] bool — pairs the host oracle must redo
      bits: [n, R+1, R+1] uint8 (only when cfg.backtrace)
    """
    R = cfg.read_size
    W = R + 1
    genasm = cfg.algo == ALGO_GENASM
    gi, gd, x = (1, 1, 1) if genasm else (cfg.gap_i, cfg.gap_d, cfg.mismatch)
    n = pats.shape[0]

    plens = plens.astype(I32)
    tlens = tlens.astype(I32)
    # tape aliasing: plen == tlen+1 is served here (the boundary chain),
    # plen > tlen+1 by the exact-tape oracle; GenASM has neither
    aliased = (plens == tlens + 1) & (not genasm)
    multi_alias = (plens > tlens + 1) & (not genasm)

    lane = jax.lax.broadcasted_iota(I32, (n, W), 1)
    # pats_sh[:, v] = pattern[v-1]
    pats_sh = jnp.pad(pats, ((0, 0), (1, 0)))[:, :W].astype(jnp.int32)
    txts_t = txts.T.astype(jnp.int32)  # [R, n]

    # Row 0: v*GAP_D, except the aliased pairs' column plen holds GAP_I
    # (row-init h=1 overwrote tape slot nc*1 == plen; ref: nw.c:124-130).
    row0 = lane * gd
    row0 = jnp.where(aliased[:, None] & (lane == plens[:, None]), gi, row0)

    valid_lane = lane <= plens[:, None]

    def step(carry, i):
        prev, score, overflow = carry
        h = i + 1
        tch = txts_t[i]  # [n]
        subc = jnp.where(pats_sh == tch[:, None], 0, x)
        prev_s = shift_right_lanes(prev, 0)
        indep = jnp.minimum(prev + gi, prev_s + subc)
        # Column-0 boundary: h*GAP_I, or the aliased chain cell(h-1, plen).
        b_clean = h * gi
        b_alias = jnp.where(h == 1, gi, gather_lane(prev, plens))
        col0 = jnp.where(aliased, b_alias, b_clean)
        z = jnp.where(lane == 0, col0[:, None], indep)
        cur = min_plus_scan(z, gd)
        # int16-range check on the live region (ref cells are int16).
        live = valid_lane & (h <= tlens)[:, None]
        overflow = overflow | jnp.any(live & (jnp.abs(cur) > INT16_MAX), axis=1)
        score = jnp.where(h == tlens, gather_lane(cur, plens), score)
        if cfg.backtrace:
            cur_s = shift_right_lanes(cur, 0)
            del_eq = cur == cur_s + gd
            ins_eq = cur == prev + gi
            x_eq = cur == prev_s + x
            code = jnp.where(del_eq, 0, jnp.where(ins_eq, 1, jnp.where(x_eq, 3, 2)))
            bits_row = code.astype(jnp.uint8)
        else:
            bits_row = jnp.zeros((n, 0), jnp.uint8)
        return (cur, score, overflow), bits_row

    # The reference's score is the last cell its loops wrote, so a
    # half-empty pair scores 0 there; GenASM scores it plen + tlen (tlen
    # == 0 never reaches h == tlens: its score is the row-0 cell).
    score0 = jnp.where(tlens == 0, plens * gd, 0) if genasm \
        else jnp.zeros(n, I32)
    init = (row0, score0, jnp.zeros(n, bool))
    (_, scores, overflow), bits_rows = jax.lax.scan(step, init, jnp.arange(R))
    if genasm:
        scores = jnp.minimum(scores, cfg.max_score + 1)
    else:
        scores = jnp.where(plens == 0, 0, scores)

    out = {
        "scores": scores,
        "needs_fallback": multi_alias | overflow,
    }
    if cfg.backtrace:
        # bits_rows: [R, n, W] for h = 1..R; prepend an unused h=0 row,
        # then pack 4 two-bit codes per byte (a quarter of the D2H bytes).
        bits = jnp.concatenate(
            [jnp.zeros((1, n, W), jnp.uint8), bits_rows], axis=0)
        bits = jnp.transpose(bits, (1, 0, 2))
        w4 = -(-W // 4)
        padded = jnp.pad(bits, ((0, 0), (0, 0), (0, 4 * w4 - W)))
        quads = padded.reshape(n, R + 1, w4, 4).astype(jnp.uint32)
        shifts = (jnp.arange(4, dtype=jnp.uint32) * 2)[None, None, None, :]
        out["bits"] = jnp.sum(quads << shifts, axis=3).astype(jnp.uint8)
    return out
