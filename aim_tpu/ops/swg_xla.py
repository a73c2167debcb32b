"""SWG (Gotoh affine-gap, global, minimizing) kernel — pure-XLA batch
implementation.

Same vectorization as nw_xla: lanes = DP columns, scan over text rows.
Per row, the I matrix is elementwise from the previous row; the coupled
M/D in-row chain reduces to ONE min-plus prefix scan because

    D[v] = min(M[v-1]+GO+GE, D[v-1]+GE),  M[v] = min(c[v], D[v])
    ==>  D[v] = min(c[v-1]+GO+GE, D[v-1]+GE)      (GE <= GO+GE)

where c[v] = min(diag + sub, I[v]) depends only on the previous row
(ref recurrence: SWG/DPU-WRAM/dpu/swg.c:146-163).

Reference semantics notes:
  * MAX_SCORE doubles as the init sentinel (ref: swg.c:128-143).
  * Flat-tape aliasing for plen == tlen+1 handled via the boundary chain
    (column-0 triple of row h>=2 is the (h-1, plen) triple); plen > tlen+1
    pairs are flagged for the native oracle.
  * Cells are int8 when MAX_SCORE < 127 (short-read tier) else int16.  We
    compute in int32 and flag pairs that could hit cell-type wrap anywhere
    (where the reference's per-op truncation becomes observable) for the
    oracle; on real data with sane costs nothing is flagged.

Direction bits (cfg.backtrace): see native.oracle swg walker —
bits0..1 M-choice (D/I/diag-M/diag-X priority, ref swg.c:79-98),
bit2 D-open, bit3 I-open.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from aim_tpu.config import AlignConfig
from aim_tpu.ops.common import gather_lane, min_plus_scan, shift_right_lanes

I32 = jnp.int32


@functools.partial(jax.jit, static_argnames=("cfg",))
def swg_forward(pats, txts, plens, tlens, *, cfg: AlignConfig):
    R = cfg.read_size
    W = R + 1
    mat, mis = cfg.match, cfg.mismatch
    go, ge = cfg.gap_o, cfg.gap_e
    ms = cfg.max_score
    n = pats.shape[0]
    cmax = 127 if cfg.cell_width == 1 else 32767
    # Any live value beyond this could wrap under the reference's cell type
    # somewhere in an intermediate; conservatively flag.
    margin = go + ge + max(mis, abs(mat), ge)

    plens = plens.astype(I32)
    tlens = tlens.astype(I32)
    aliased = plens == tlens + 1
    multi_alias = plens > tlens + 1

    lane = jax.lax.broadcasted_iota(I32, (n, W), 1)
    pats_sh = jnp.pad(pats, ((0, 0), (1, 0)))[:, :W].astype(jnp.int32)
    txts_t = txts.T.astype(jnp.int32)

    # Row 0 triples (ref: swg.c:128-137): v=0 -> (M=0, I=D=MAX_SCORE);
    # v>=1 -> D = GO + v*GE, I = MAX_SCORE, M = D.  Aliased pairs' slot
    # v == plen was overwritten by the h=1 row-init triple
    # (D=MAX_SCORE, I=GO+GE, M=I).
    d0 = jnp.where(lane == 0, ms, go + lane * ge)
    i0 = jnp.full((n, W), ms, I32)
    m0 = jnp.where(lane == 0, 0, d0)
    at_alias = aliased[:, None] & (lane == plens[:, None]) & (lane > 0)
    d0 = jnp.where(at_alias, ms, d0)
    i0 = jnp.where(at_alias, go + ge, i0)
    m0 = jnp.where(at_alias, go + ge, m0)

    valid_lane = lane <= plens[:, None]

    def step(carry, i):
        pm, pi, pd, score, overflow = carry
        h = i + 1
        tch = txts_t[i]
        subc = jnp.where(pats_sh == tch[:, None], mat, mis)
        pm_s = shift_right_lanes(pm, 0)
        # Column-0 boundary triple.
        mb_clean = go + h * ge          # M = I = GO + h*GE, D = MAX_SCORE
        ib_clean = mb_clean
        db_clean = jnp.full((n,), ms, I32)
        # Row 0 already holds the overwritten triple at the aliased slot,
        # so a plain gather of the previous row realizes the chain for all h.
        m_b = jnp.where(aliased, gather_lane(pm, plens), mb_clean)
        i_b = jnp.where(aliased, gather_lane(pi, plens), ib_clean)
        d_b = jnp.where(aliased, gather_lane(pd, plens), db_clean)
        # I row: elementwise (v >= 1).
        i_cur = jnp.minimum(pm + go + ge, pi + ge)
        i_cur = jnp.where(lane == 0, i_b[:, None], i_cur)
        # c[v] = min(diag + sub, I[v]) for v >= 1.
        c = jnp.minimum(pm_s + subc, i_cur)
        # D scan input: z[0] = D boundary, z[1] = M0 + GO + GE,
        # z[v>=2] = c[v-1] + GO + GE.
        c_s = shift_right_lanes(c, 0)
        z = jnp.where(lane == 0, d_b[:, None],
                      jnp.where(lane == 1, m_b[:, None] + go + ge,
                                c_s + go + ge))
        d_cur = min_plus_scan(z, ge)
        m_cur = jnp.minimum(c, d_cur)
        m_cur = jnp.where(lane == 0, m_b[:, None], m_cur)
        live = valid_lane & (h <= tlens)[:, None]
        mx = jnp.maximum(jnp.abs(m_cur), jnp.maximum(jnp.abs(i_cur), jnp.abs(d_cur)))
        overflow = overflow | jnp.any(live & (mx > cmax - margin), axis=1)
        score = jnp.where(h == tlens, gather_lane(m_cur, plens), score)
        if cfg.backtrace:
            m_cur_s = shift_right_lanes(m_cur, 0)
            choice = jnp.where(m_cur == d_cur, 0,
                               jnp.where(m_cur == i_cur, 1,
                                         jnp.where(m_cur == pm_s + mat, 2, 3)))
            d_open = (d_cur == m_cur_s + go + ge).astype(jnp.uint8)
            i_open = (i_cur == pm + go + ge).astype(jnp.uint8)
            bits_row = (choice.astype(jnp.uint8) | (d_open << 2) | (i_open << 3))
        else:
            bits_row = jnp.zeros((n, 0), jnp.uint8)
        d_cur0 = jnp.where(lane == 0, d_b[:, None], d_cur)
        return (m_cur, i_cur, d_cur0, score, overflow), bits_row

    init = (m0, i0, d0, jnp.zeros(n, I32), jnp.zeros(n, bool))
    (_, _, _, scores, overflow), bits_rows = jax.lax.scan(step, init, jnp.arange(R))
    # the reference's score is the last cell its loops wrote: 0 for a
    # half-empty pair (tlen == 0 never reaches h == tlens)
    scores = jnp.where(plens == 0, 0, scores)

    out = {
        "scores": scores,
        "needs_fallback": multi_alias | overflow,
    }
    if cfg.backtrace:
        # Pack 2 four-bit codes per byte (half the D2H bytes).
        bits = jnp.concatenate(
            [jnp.zeros((1, n, W), jnp.uint8), bits_rows], axis=0)
        bits = jnp.transpose(bits, (1, 0, 2))
        w2 = -(-W // 2)
        padded = jnp.pad(bits, ((0, 0), (0, 0), (0, 2 * w2 - W)))
        duos = padded.reshape(n, R + 1, w2, 2).astype(jnp.uint32)
        shifts = (jnp.arange(2, dtype=jnp.uint32) * 4)[None, None, None, :]
        out["bits"] = jnp.sum(duos << shifts, axis=3).astype(jnp.uint8)
    return out
