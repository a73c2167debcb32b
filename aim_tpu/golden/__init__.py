"""Pure-Python golden implementations (slow, scalar) — the executable spec.

These simulate the reference semantics directly, including the flat
1-D DP tape (``dp[(tlen+1)*h + v]``, v ranging to plen) whose slot aliasing
for plen > tlen is observable behavior (ref: NW/DPU-WRAM/dpu/nw.c:139-145).
They are used in tests to cross-check the native C++ oracle and the device
kernels on small inputs.  Scores follow each algorithm's conventions:
NW/SWG penalties (minimized), WFA accumulated score (or MAX_SCORE+1 on
overflow, ref: WFA/DPU-MRAM/dpu/wfa.c:399-404).
"""

from __future__ import annotations

import numpy as np

I16 = np.int16
WFA_NULL = np.int16(-(2 ** 15) // 2)  # INT16_MIN / 2


def _as_bytes(s):
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    if isinstance(s, str):
        return s.encode()
    return bytes(np.asarray(s, np.uint8).tobytes())


# ---------------------------------------------------------------------------
# NW golden (ref: NW/DPU-WRAM/dpu/nw.c:109-153, traceback :67-107)
# ---------------------------------------------------------------------------

def nw_golden(pattern, text, mismatch=3, gap_i=4, gap_d=4, backtrace=False):
    p, t = _as_bytes(pattern), _as_bytes(text)
    plen, tlen = len(p), len(t)
    nc = tlen + 1
    tape = np.zeros(nc * tlen + plen + 2, I16)
    tape[0] = 0
    cell = 0
    for v in range(1, plen + 1):
        cell += gap_d
        tape[v] = cell
    cell = 0
    for h in range(1, tlen + 1):
        cell += gap_i
        tape[nc * h] = cell
    score = I16(0)
    for h in range(1, tlen + 1):
        for v in range(1, plen + 1):
            dl = I16(tape[nc * h + v - 1] + gap_d)
            ins = I16(tape[nc * (h - 1) + v] + gap_i)
            dia = I16(tape[nc * (h - 1) + v - 1] + (0 if p[v - 1] == t[h - 1] else mismatch))
            score = min(dia, min(ins, dl))
            tape[nc * h + v] = score
    out = {"score": int(score)}
    if backtrace:
        max_ops = plen + tlen
        ops = ["M"] * (2 * (plen + tlen) + 4)
        op = max_ops - 1
        h, v = tlen, plen
        while h > 0 and v > 0:
            cur = tape[nc * h + v]
            if cur == I16(tape[nc * h + v - 1] + gap_d):
                ops[op] = "D"; op -= 1; v -= 1
            elif cur == I16(tape[nc * (h - 1) + v] + gap_i):
                ops[op] = "I"; op -= 1; h -= 1
            else:
                ops[op] = "X" if cur == I16(tape[nc * (h - 1) + v - 1] + mismatch) else "M"
                op -= 1; h -= 1; v -= 1
        while h > 0:
            ops[op] = "I"; op -= 1; h -= 1
        while v > 0:
            ops[op] = "D"; op -= 1; v -= 1
        out["cigar"] = rle("".join(ops[op + 1:max_ops]))
    return out


# ---------------------------------------------------------------------------
# SWG golden (ref: SWG/DPU-WRAM/dpu/swg.c:121-171, traceback :45-119)
# ---------------------------------------------------------------------------

def swg_golden(pattern, text, match=0, mismatch=3, gap_o=4, gap_e=1,
               max_score=26, cell_width=1, backtrace=False):
    C = np.int8 if cell_width == 1 else np.int16
    p, t = _as_bytes(pattern), _as_bytes(text)
    plen, tlen = len(p), len(t)
    nc = tlen + 1
    size = nc * tlen + plen + 2
    M = np.zeros(size, C); Ix = np.zeros(size, C); D = np.zeros(size, C)
    D[0] = C(max_score); Ix[0] = C(max_score); M[0] = 0
    for v in range(1, plen + 1):
        D[v] = C(gap_o + v * gap_e); Ix[v] = C(max_score); M[v] = D[v]
    for h in range(1, tlen + 1):
        D[nc * h] = C(max_score); Ix[nc * h] = C(gap_o + h * gap_e); M[nc * h] = Ix[nc * h]
    score = 0
    for h in range(1, tlen + 1):
        for v in range(1, plen + 1):
            i0, iu, il, idg = nc * h + v, nc * h + v - 1, nc * (h - 1) + v, nc * (h - 1) + v - 1
            dl = min(C(M[iu] + gap_o + gap_e), C(D[iu] + gap_e))
            ins = min(C(M[il] + gap_o + gap_e), C(Ix[il] + gap_e))
            dia = C(M[idg] + (match if p[v - 1] == t[h - 1] else mismatch))
            D[i0] = dl; Ix[i0] = ins
            best = min(dia, min(ins, dl))
            M[i0] = best
            score = int(best)
    out = {"score": score}
    if backtrace:
        max_ops = plen + tlen
        ops = ["M"] * (2 * (plen + tlen) + 4)
        op = max_ops - 1
        h, v = tlen, plen
        layer = "M"
        while h > 0 and v > 0:
            i0 = nc * h + v
            if layer == "D":
                ops[op] = "D"; op -= 1
                if D[i0] == C(M[i0 - 1] + gap_o + gap_e):
                    layer = "M"
                v -= 1
            elif layer == "I":
                ops[op] = "I"; op -= 1
                if Ix[i0] == C(M[i0 - nc] + gap_o + gap_e):
                    layer = "M"
                h -= 1
            else:
                if M[i0] == D[i0]:
                    layer = "D"
                elif M[i0] == Ix[i0]:
                    layer = "I"
                elif M[i0] == C(M[i0 - nc - 1] + match):
                    ops[op] = "M"; op -= 1; h -= 1; v -= 1
                elif M[i0] == C(M[i0 - nc - 1] + mismatch):
                    ops[op] = "X"; op -= 1; h -= 1; v -= 1
                else:
                    raise AssertionError("SWG backtrace: no operation found")
        while h > 0:
            ops[op] = "I"; op -= 1; h -= 1
        while v > 0:
            ops[op] = "D"; op -= 1; v -= 1
        out["cigar"] = rle("".join(ops[op + 1:max_ops]))
    return out


# ---------------------------------------------------------------------------
# WFA golden (ref: WFA/DPU-MRAM/dpu/wfa.c + wfa_backtracing.c)
# ---------------------------------------------------------------------------

class _Wf:
    __slots__ = ("klo", "khi", "m", "i", "d", "m_null", "i_null", "d_null")

    def __init__(self, lo, hi, has_i, has_d):
        self.klo, self.khi = lo, hi
        self.m = {}
        self.i = {} if has_i else None
        self.d = {} if has_d else None
        self.m_null = False
        self.i_null = not has_i
        self.d_null = not has_d


def wfa_golden(pattern, text, mismatch=3, gap_o=4, gap_e=1, max_score=50,
               adaptive=False, backtrace=False, overflow_backtrace=False):
    p, t = _as_bytes(pattern), _as_bytes(text)
    plen, tlen = len(p), len(t)
    ak = tlen - plen
    wfs: dict[int, _Wf | None] = {}
    w0 = _Wf(0, 0, False, False)
    w0.m[0] = I16(0)
    wfs[0] = w0
    score = 0

    def fetch(d, lo, hi, k):
        if d is None or not (lo <= k <= hi):
            return WFA_NULL
        return d.get(k, WFA_NULL)

    while True:
        wf = wfs.get(score)
        m_null = wf is None or wf.m_null
        if not m_null:
            # extend
            for k in range(wf.klo, wf.khi + 1):
                off = int(wf.m.get(k, WFA_NULL))
                if off < 0:
                    continue
                v, h = off - k, off
                while 0 <= v < plen and 0 <= h < tlen and p[v] == t[h]:
                    v += 1; h += 1
                wf.m[k] = I16(h)
            if adaptive and (wf.khi - wf.klo + 1) >= 10:
                dist = {}
                for k in range(wf.klo, wf.khi + 1):
                    off = int(wf.m.get(k, WFA_NULL))
                    dist[k] = max(plen - (off - k), tlen - off)
                mind = min(min(dist.values()), max(plen, tlen))
                klo0, khi0 = wf.klo, wf.khi
                top = min(ak - 1, wf.khi)
                for k in range(klo0, top):
                    if dist[k] - mind <= 50:
                        break
                    wf.klo += 1
                bot = max(ak + 1, wf.klo)
                for k in range(khi0, bot, -1):
                    if dist[k] - mind <= 50:
                        break
                    wf.khi -= 1
                if wf.klo > wf.khi:
                    wf.m_null = wf.i_null = wf.d_null = True
                    wf.klo, wf.khi = klo0, khi0
                m_null = wf.m_null
        if not m_null and wf.klo <= ak <= wf.khi and int(wf.m.get(ak, WFA_NULL)) >= tlen:
            break
        score += 1
        if score > max_score:
            if backtrace and overflow_backtrace:
                # WRAM-variant compat rendition (opt-in): the reference's
                # WRAM tier backtraces on overflow through an
                # out-of-bounds wavefront read (UB, ref:
                # WFA/DPU-WRAM/dpu/wfa.c:369-376) — no bit-exact target
                # exists, so the DEFINED rendition walks from the deepest
                # live computed level (<= max_score).
                s0 = max_score
                while s0 > 0 and (wfs.get(s0) is None or wfs[s0].m_null):
                    s0 -= 1
                return {"score": score,
                        "cigar": _wfa_backtrace_golden(
                            wfs, p, t, plen, tlen, mismatch, gap_o, gap_e,
                            s0)}
            return {"score": score, "cigar": "1M"} if backtrace else {"score": score}
        # compute_next
        ws, wo, we = wfs.get(score - mismatch), wfs.get(score - gap_o - gap_e), wfs.get(score - gap_e)
        m_sub_null = score - mismatch < 0 or ws is None or ws.m_null
        m_o_null = score - gap_o - gap_e < 0 or wo is None or wo.m_null
        i_e_null = score - gap_e < 0 or we is None or we.i_null or we.i is None
        d_e_null = score - gap_e < 0 or we is None or we.d_null or we.d is None
        i_out_null = m_o_null and i_e_null
        d_out_null = m_o_null and d_e_null
        if m_sub_null and i_out_null and d_out_null:
            wfs[score] = None
            continue
        sub_lo, sub_hi = (1, -1) if m_sub_null else (ws.klo, ws.khi)
        o_lo, o_hi = (1, -1) if m_o_null else (wo.klo, wo.khi)
        e_lo, e_hi = (1, -1) if (i_e_null and d_e_null) else (we.klo, we.khi)
        lo = min(sub_lo, o_lo, e_lo) - 1
        hi = max(sub_hi, o_hi, e_hi) + 1
        nw = _Wf(lo, hi, not i_out_null, not d_out_null)
        for k in range(lo, hi + 1):
            ins = I16(-10)
            if not (m_o_null and i_e_null):
                ins_g = fetch(None if m_o_null else wo.m, o_lo, o_hi, k - 1)
                ins_i = fetch(None if i_e_null else we.i, e_lo, e_hi, k - 1)
                if ins_g == WFA_NULL and ins_i == WFA_NULL:
                    ins = WFA_NULL
                else:
                    ins = I16(max(ins_g, ins_i) + 1)
                nw.i[k] = ins
            dl = I16(-10)
            if not (m_o_null and d_e_null):
                del_g = fetch(None if m_o_null else wo.m, o_lo, o_hi, k + 1)
                del_d = fetch(None if d_e_null else we.d, e_lo, e_hi, k + 1)
                dl = I16(max(del_g, del_d))
                nw.d[k] = dl
            sub = I16(-10)
            if not m_sub_null:
                sub = I16(ws.m[k] + 1) if sub_lo <= k <= sub_hi else WFA_NULL
            nw.m[k] = I16(max(dl, max(sub, ins)))
        wfs[score] = nw

    out = {"score": score}
    if backtrace:
        out["cigar"] = _wfa_backtrace_golden(
            wfs, p, t, plen, tlen, mismatch, gap_o, gap_e, score)
    return out


def _wfa_backtrace_golden(wfs, p, t, plen, tlen, mismatch, gap_o, gap_e,
                          alignment_score):
    ak = tlen - plen
    score, k = alignment_score, ak
    ops = ["M"] * (2 * (plen + tlen) + 4)
    max_ops = plen + tlen
    op = max_ops - 1
    # Guarded start read (the normal path's start is always in band; the
    # overflow-compat start may not be — out-of-band reads NULL).
    w0 = wfs.get(alignment_score)
    offset = int(w0.m.get(k, WFA_NULL)) \
        if (w0 is not None and w0.klo <= k <= w0.khi) else int(WFA_NULL)
    v, h = offset - k, offset
    valid = 0 < v <= plen and 0 < h <= tlen
    btype = "M"

    def m_read(s, kk):  # no m_null check (ref: wfa_backtracing.c:73-91,148-166)
        if s < 0:
            return None
        w = wfs.get(s)
        if w is not None and w.klo <= kk <= w.khi:
            return int(w.m.get(kk, WFA_NULL))
        return None

    def d_read(s, kk):
        if s < 0:
            return None
        w = wfs.get(s)
        if w is not None and not w.d_null and w.klo <= kk <= w.khi:
            return int(w.d.get(kk, WFA_NULL))
        return None

    def i_read(s, kk):
        if s < 0:
            return None
        w = wfs.get(s)
        if w is not None and w.i is not None and not w.i_null and w.klo <= kk <= w.khi:
            return int(w.i.get(kk, WFA_NULL))
        return None

    NULL = int(WFA_NULL)
    while v > 0 and h > 0 and score > 0:
        if not valid:
            valid = 0 < v <= plen and 0 < h <= tlen
            if valid:
                if k < ak:
                    for _ in range(k, ak):
                        ops[op] = "I"; op -= 1
                elif k > ak:
                    for _ in range(ak, k):
                        ops[op] = "D"; op -= 1
        s_o, s_e, s_x = score - gap_o - gap_e, score - gap_e, score - mismatch
        de = d_read(s_e, k + 1) if btype != "I" else None
        do = m_read(s_o, k + 1) if btype != "I" else None
        ie = i_read(s_e, k - 1) if btype != "D" else None
        io = m_read(s_o, k - 1) if btype != "D" else None
        mm = m_read(s_x, k) if btype == "M" else None
        del_ext = NULL if de is None else de
        del_open = NULL if do is None else do
        ins_ext = NULL if ie is None else int(I16(ie + 1))
        ins_open = NULL if io is None else int(I16(io + 1))
        misms = NULL if mm is None else int(I16(mm + 1))
        max_all = max(misms, max(ins_ext, ins_open), max(del_ext, del_open))
        if btype == "M":
            for _ in range(offset - max_all):
                ops[op] = "M"; op -= 1
            offset = max_all
            v, h = offset - k, offset
            if v <= 0 or h <= 0:
                break
        if max_all == del_ext:
            if valid:
                ops[op] = "D"; op -= 1
            score = s_e; k += 1; btype = "D"
        elif max_all == del_open:
            if valid:
                ops[op] = "D"; op -= 1
            score = s_o; k += 1; btype = "M"
        elif max_all == ins_ext:
            if valid:
                ops[op] = "I"; op -= 1
            score = s_e; k -= 1; offset -= 1; btype = "I"
        elif max_all == ins_open:
            if valid:
                ops[op] = "I"; op -= 1
            score = s_o; k -= 1; offset -= 1; btype = "M"
        elif max_all == misms:
            if valid:
                ops[op] = "X"; op -= 1
            score = s_x; offset -= 1
        else:
            raise AssertionError("WFA backtrace: no link found")
        v, h = offset - k, offset
    if score == 0:
        for _ in range(offset):
            ops[op] = "M"; op -= 1
    else:
        while v > 0:
            ops[op] = "D"; op -= 1; v -= 1
        while h > 0:
            ops[op] = "I"; op -= 1; h -= 1
    return rle("".join(ops[op + 1:max_ops]))


def rle(ops: str) -> str:
    """Run-length encode an ops string the way edit_cigar_print does
    (ref: host.c:69-89)."""
    if not ops:
        return ""
    parts = []
    last, run = ops[0], 1
    for c in ops[1:]:
        if c == last:
            run += 1
        else:
            parts.append(f"{run}{last}")
            last, run = c, 1
    parts.append(f"{run}{last}")
    return "".join(parts)
