"""WFA / WFA-adaptive (gap-affine wavefront) kernel — pure-XLA batch
implementation.

Vectorization: lanes = wavefront diagonals k (dense over [-S, S], physical
lane = k + S), batch rows = pairs, one global score loop advanced in
lock-step for the whole batch with per-pair done masks.  This is the batch
shape of the reference's per-tasklet score loop
(ref: WFA/DPU-MRAM/dpu/wfa.c:356-407).

Key device formulations:
  * extend (the reference's innermost char-match loop, wfa.c:193-215) is a
    single gather into a precomputed per-diagonal "next mismatch" table NM:
    NM[n,k,h] = first position h' >= h that fails the match condition
    (v' = h'-k in [0,plen), h' in [0,tlen), pattern[v']==text[h']); the
    extended offset is simply NM[offset].  NM is built once per batch with
    a reverse cumulative-min — O(K*R log R) vector work replacing the
    serial loop.
  * wavefront history is a dense [n, S+2, 3, K] int16 tensor in device
    memory plus klo/khi/flags sidecars — the MRAM-tier layout (ref
    component store, dpu_allocator_mram.c) without the serialization; the
    backtrace walks it on host (native.wfa_backtrace_batch).
  * all reference quirks preserved: OFFSET_NULL = INT16_MIN/2 arithmetic,
    the live ``-10`` defaults of skipped I/D branches (wfa.c:243,255),
    del = max(del_g, del_d) with NO both-null special case (wfa.c:262),
    reduce trim loops with their exact break/limits semantics and the
    extent-restoring null case (wfa.c:70-141), overflow score = MAX_SCORE+1
    with no backtrace (the MRAM-tier behavior, wfa.c:399-404).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from aim_tpu.config import AlignConfig
from aim_tpu.ops.common import gather_lane

I16 = jnp.int16
I32 = jnp.int32
NULL16 = jnp.int16(-16384)
BIG = jnp.int32(2 ** 20)  # above any offset or distance (R < 32767)


def build_nm_table(pats, txts, plens, tlens, smax: int, read_size: int):
    """NM[n, K, h] = first mismatch position >= h on diagonal k - smax.

    h ranges over [0, R]; NM values are in [0, R] (position R = sentinel,
    can never be exceeded since h' < tlen <= R fails first).  Int32 keys
    with an associative scan, stored as int16 (R < 32767): on the H100
    this builds faster than int16 keys or lax.cummin (PERF.md).
    """
    n, R = pats.shape
    K = 2 * smax + 1
    k = jnp.arange(K, dtype=I32) - smax            # [K]
    h = jnp.arange(R, dtype=I32)                    # [R]
    v = h[None, :] - k[:, None]                     # [K, R]
    vc = jnp.clip(v, 0, R - 1)
    pg = jnp.take(pats, vc.reshape(-1), axis=1).reshape(n, K, R)
    ok = (v[None] >= 0) & (v[None] < plens[:, None, None]) \
        & (h[None, None] < tlens[:, None, None])
    match = ok & (pg == txts[:, None, :])
    # R as the match-fill: since R > any mismatch position h, the reverse
    # cumulative-min yields the first mismatch position (or R if none).
    arr = jnp.where(match, R, h[None, None])
    arr = jnp.concatenate([arr, jnp.full((n, K, 1), R, I32)], axis=2)
    nm = jax.lax.associative_scan(jnp.minimum, arr, reverse=True, axis=2)
    return nm.astype(I16)                           # [n, K, R+1]


def extend(nm, off):
    """ext[n, k] = nm[n, k, off[n, k]]: the furthest match-run end from
    each diagonal's offset (off in [0, R])."""
    return jnp.take_along_axis(nm, off[:, :, None], axis=2)[:, :, 0]


@functools.partial(jax.jit, static_argnames=("cfg",))
def wfa_forward(pats, txts, plens, tlens, *, cfg: AlignConfig):
    """Batch WFA forward.  Returns scores and, when cfg.backtrace, the dense
    wavefront history for the host walker.

    Output dict:
      scores: [n] int32  (end score, or MAX_SCORE+1 on overflow)
      hist_m/hist_i/hist_d: [n, S+1, K] int16   (backtrace only)
      klo/khi: [n, S+1] int32; flags: [n, S+1] uint8 (bit0 exists,
      bit1 m_null, bit2 i_null, bit3 d_null)
    """
    smax = cfg.max_score
    R = cfg.read_size
    K = 2 * smax + 1
    S2 = smax + 2  # slot smax+1 is scratch for the final compute_next
    n = pats.shape[0]
    x, go, ge = cfg.mismatch, cfg.gap_o, cfg.gap_e

    plens = plens.astype(I32)
    tlens = tlens.astype(I32)
    ak = tlens - plens                       # alignment diagonal, per pair
    kvec = jnp.arange(K, dtype=I32) - smax   # [K]

    nm = build_nm_table(pats, txts, plens, tlens, smax, R)

    # Dense history.
    hm = jnp.full((n, S2, K), NULL16, I16)
    hi = jnp.full((n, S2, K), NULL16, I16)
    hd = jnp.full((n, S2, K), NULL16, I16)
    klo = jnp.full((n, S2), 1, I32)
    khi = jnp.full((n, S2), -1, I32)
    flags = jnp.zeros((n, S2), jnp.uint8)
    # score 0: lo = hi = 0, m[0] = 0, i/d null (ref: wfa.c:364-366).
    hm = hm.at[:, 0, smax].set(0)
    klo = klo.at[:, 0].set(0)
    khi = khi.at[:, 0].set(0)
    flags = flags.at[:, 0].set(1 | (1 << 2) | (1 << 3))

    def read_slot(bufs, s):
        return tuple(jax.lax.dynamic_index_in_dim(b, s, 1, keepdims=False)
                     for b in bufs)

    def cond(st):
        s, active = st[0], st[1]
        return (s <= smax) & jnp.any(active)

    def body(st):
        s, active, scores, hm, hi, hd, klo, khi, flags = st
        m, kl, kh, fl = read_slot((hm, klo, khi, flags), s)
        exists = (fl & 1).astype(bool)
        m_null = ~exists | ((fl >> 1) & 1).astype(bool)
        inr = (kl[:, None] <= kvec) & (kvec <= kh[:, None])

        # ---- extend ----
        offi = m.astype(I32)
        do_ext = active[:, None] & ~m_null[:, None] & inr & (offi >= 0)
        ext = extend(nm, jnp.clip(offi, 0, R)).astype(I32)
        offi = jnp.where(do_ext, ext, offi)
        m = offi.astype(I16)
        hm = jax.lax.dynamic_update_index_in_dim(hm, m, s, 1)

        # ---- reduce (WFA-adaptive) ----
        if cfg.adaptive:
            width = kh - kl + 1
            do_red = active & ~m_null & (width >= 10)
            v = offi - kvec[None]
            dist = jnp.maximum(plens[:, None] - v, tlens[:, None] - offi)
            dmask = jnp.where(inr, dist, BIG)
            mind = jnp.minimum(jnp.min(dmask, axis=1),
                               jnp.maximum(plens, tlens))
            keep = (dist - mind[:, None]) <= 50
            top_limit = jnp.minimum(ak - 1, kh)
            cand_lo = jnp.where((kvec >= kl[:, None]) & (kvec < top_limit[:, None])
                                & keep, kvec, BIG)
            fk = jnp.min(cand_lo, axis=1)
            klo_new = jnp.maximum(kl, jnp.minimum(fk, top_limit))
            bottom_limit = jnp.maximum(ak + 1, klo_new)
            cand_hi = jnp.where((kvec <= kh[:, None]) & (kvec > bottom_limit[:, None])
                                & keep, kvec, -BIG)
            lk = jnp.max(cand_hi, axis=1)
            khi_new = jnp.minimum(kh, jnp.maximum(lk, bottom_limit))
            nullify = do_red & (klo_new > khi_new)
            shrink = do_red & ~nullify
            kl = jnp.where(shrink, klo_new, kl)
            kh = jnp.where(shrink, khi_new, kh)
            fl = jnp.where(nullify, fl | 0b1110, fl)
            klo = jax.lax.dynamic_update_index_in_dim(klo, kl, s, 1)
            khi = jax.lax.dynamic_update_index_in_dim(khi, kh, s, 1)
            flags = jax.lax.dynamic_update_index_in_dim(flags, fl, s, 1)
            m_null = m_null | nullify
            inr = (kl[:, None] <= kvec) & (kvec <= kh[:, None])

        # ---- end reached ----
        m_at_ak = gather_lane(offi, jnp.clip(ak + smax, 0, K - 1))
        er = active & ~m_null & (kl <= ak) & (ak <= kh) & (m_at_ak >= tlens)
        scores = jnp.where(er, s, scores)
        active = active & ~er

        # ---- compute next score ----
        s2 = s + 1

        def rd(sx):
            valid = sx >= 0
            i = jnp.maximum(sx, 0)
            f, l, hgh = read_slot((flags, klo, khi), i)
            mw, iw, dw = read_slot((hm, hi, hd), i)
            ex = valid & (f & 1).astype(bool)
            return ex, (f >> 1) & 1, (f >> 2) & 1, (f >> 3) & 1, l, hgh, mw, iw, dw

        ex_sub, mn_sub, _, _, l_sub, h_sub, mw_sub, _, _ = rd(s2 - x)
        ex_o, mn_o, _, _, l_o, h_o, mw_o, _, _ = rd(s2 - go - ge)
        ex_e, _, in_e, dn_e, l_e, h_e, _, iw_e, dw_e = rd(s2 - ge)

        m_sub_null = ~ex_sub | mn_sub.astype(bool)
        m_o_null = ~ex_o | mn_o.astype(bool)
        i_e_null = ~ex_e | in_e.astype(bool)
        d_e_null = ~ex_e | dn_e.astype(bool)
        i_out_null = m_o_null & i_e_null
        d_out_null = m_o_null & d_e_null
        allnull = m_sub_null & i_out_null & d_out_null

        sub_lo = jnp.where(m_sub_null, 1, l_sub)
        sub_hi = jnp.where(m_sub_null, -1, h_sub)
        o_lo = jnp.where(m_o_null, 1, l_o)
        o_hi = jnp.where(m_o_null, -1, h_o)
        e_null_both = i_e_null & d_e_null
        e_lo = jnp.where(e_null_both, 1, l_e)
        e_hi = jnp.where(e_null_both, -1, h_e)
        lo = jnp.minimum(jnp.minimum(sub_lo, o_lo), e_lo) - 1
        hi_ = jnp.maximum(jnp.maximum(sub_hi, o_hi), e_hi) + 1

        def sl(w):  # value at lane k-1
            r = jnp.roll(w, 1, axis=1)
            return jnp.where(jnp.arange(K) >= 1, r, NULL16)

        def sr(w):  # value at lane k+1
            r = jnp.roll(w, -1, axis=1)
            return jnp.where(jnp.arange(K) <= K - 2, r, NULL16)

        km1_in = lambda lo_, hi_2: (lo_[:, None] <= kvec - 1) & (kvec - 1 <= hi_2[:, None])
        kp1_in = lambda lo_, hi_2: (lo_[:, None] <= kvec + 1) & (kvec + 1 <= hi_2[:, None])
        k_in = lambda lo_, hi_2: (lo_[:, None] <= kvec) & (kvec <= hi_2[:, None])

        ins_g = jnp.where(~m_o_null[:, None] & km1_in(o_lo, o_hi), sl(mw_o), NULL16)
        ins_i = jnp.where(~i_e_null[:, None] & km1_in(e_lo, e_hi), sl(iw_e), NULL16)
        both_null = (ins_g == NULL16) & (ins_i == NULL16)
        ins = jnp.where(both_null, NULL16,
                        (jnp.maximum(ins_g, ins_i) + I16(1)).astype(I16))
        del_g = jnp.where(~m_o_null[:, None] & kp1_in(o_lo, o_hi), sr(mw_o), NULL16)
        del_d = jnp.where(~d_e_null[:, None] & kp1_in(e_lo, e_hi), sr(dw_e), NULL16)
        dl = jnp.maximum(del_g, del_d)
        sub = jnp.where(k_in(sub_lo, sub_hi), (mw_sub + I16(1)).astype(I16), NULL16)

        ins_m = jnp.where(i_out_null[:, None], I16(-10), ins)
        del_m = jnp.where(d_out_null[:, None], I16(-10), dl)
        sub_m = jnp.where(m_sub_null[:, None], I16(-10), sub)
        m_new = jnp.maximum(del_m, jnp.maximum(sub_m, ins_m))

        inr_new = k_in(lo, hi_)
        write = ~allnull[:, None] & inr_new
        hm = jax.lax.dynamic_update_index_in_dim(
            hm, jnp.where(write, m_new, NULL16), s2, 1)
        hi = jax.lax.dynamic_update_index_in_dim(
            hi, jnp.where(write & ~i_out_null[:, None], ins, NULL16), s2, 1)
        hd = jax.lax.dynamic_update_index_in_dim(
            hd, jnp.where(write & ~d_out_null[:, None], dl, NULL16), s2, 1)
        newf = jnp.where(
            allnull, jnp.uint8(0),
            (1 | (i_out_null.astype(jnp.uint8) << 2)
             | (d_out_null.astype(jnp.uint8) << 3)))
        flags = jax.lax.dynamic_update_index_in_dim(flags, newf, s2, 1)
        klo = jax.lax.dynamic_update_index_in_dim(
            klo, jnp.where(allnull, 1, lo), s2, 1)
        khi = jax.lax.dynamic_update_index_in_dim(
            khi, jnp.where(allnull, -1, hi_), s2, 1)

        return (s2, active, scores, hm, hi, hd, klo, khi, flags)

    st0 = (jnp.int32(0), jnp.ones(n, bool), jnp.zeros(n, I32),
           hm, hi, hd, klo, khi, flags)
    s, active, scores, hm, hi, hd, klo, khi, flags = jax.lax.while_loop(
        cond, body, st0)
    scores = jnp.where(active, smax + 1, scores)

    out = {"scores": scores}
    if cfg.backtrace:
        # Pack into two transfer arrays (two D2H copies instead of six):
        # hist [n, S+1, 3K] i16 (m | i | d along lanes) and meta
        # [n, S+1, 3] i16 (klo | khi | flags — all fit int16).
        s1 = smax + 1
        out["packed_hist"] = jnp.concatenate(
            [hm[:, :s1], hi[:, :s1], hd[:, :s1]], axis=2)
        out["packed_meta"] = jnp.stack(
            [klo[:, :s1].astype(I16), khi[:, :s1].astype(I16),
             flags[:, :s1].astype(I16)], axis=2)
    return out
