"""ctypes bindings to the native host runtime (oracle.cpp).

The shared library is built lazily with g++ on first use and cached next to
the source, keyed by a hash of the source (a checkout gives source and
library the same mtime, so mtimes cannot tell a stale build).  Everything
here also has a pure-Python reference in aim_tpu.golden.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "oracle.cpp")
_SO = os.path.join(_HERE, "_liboracle.so")
_LOCK = threading.Lock()
_LIB = None

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
_i16pv = np.ctypeslib.ndpointer(dtype=np.int16)  # strided views OK
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_chp = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")  # char*


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> str:
    """Build the library unless the one on disk was built from this exact
    source (its hash is recorded beside it)."""
    stamp = _SO + ".sha256"
    want = _source_hash()
    try:
        with open(stamp) as f:
            if f.read().strip() == want and os.path.exists(_SO):
                return _SO
    except OSError:
        pass
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
        f.write(want + "\n")
    os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    return _SO


def load():
    """Load (building if needed) the native library. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build())

        lib.aim_parse_pairs.restype = ctypes.c_long
        lib.aim_parse_pairs.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            _i8p, _i8p, _i32p, _i32p,
        ]
        lib.aim_parse_pairs_range.restype = ctypes.c_long
        lib.aim_parse_pairs_range.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            _i8p, _i8p, _i32p, _i32p,
        ]
        lib.aim_count_pairs.restype = ctypes.c_long
        lib.aim_count_pairs.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.aim_pair_offsets.restype = ctypes.c_long
        lib.aim_pair_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _i64p, _i64p,
        ]
        lib.aim_parse_pairs_at.restype = ctypes.c_long
        lib.aim_parse_pairs_at.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, _i8p, _i8p, _i32p, _i32p,
        ]
        lib.aim_nw_align.restype = None
        lib.aim_nw_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_nw_traceback_bits.restype = None
        lib.aim_nw_traceback_bits.argtypes = [
            _i8p, ctypes.c_long, ctypes.c_long, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, _chp, _i32p, _i32p,
        ]
        lib.aim_swg_align.restype = None
        lib.aim_swg_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_swg_traceback_bits.restype = None
        lib.aim_swg_traceback_bits.argtypes = [
            _i8p, ctypes.c_long, ctypes.c_long, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_align.restype = None
        lib.aim_wfa_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_backtrace_batch.restype = None
        lib.aim_wfa_backtrace_batch.argtypes = [
            _i16pv, _i16pv, _i16pv, _i32p, _i32p, _i8p, _i32p,
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, _chp, _i32p, _i32p,
        ]
        lib.aim_genasm_align.restype = None
        lib.aim_genasm_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_emit_output.restype = ctypes.c_long
        lib.aim_emit_output.argtypes = [
            ctypes.c_char_p, _i32p, _i32p, _chp, _i32p, _i32p,
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------

def parse_pairs(path: str, max_pairs: int, read_size: int, threads: int = 1):
    """Parse a '>pattern\\n<text\\n' pair file (ref: host.c get_reads).

    Returns (patterns [n,R] u8, texts [n,R] u8, plens [n] i32, tlens [n] i32).
    Raises ValueError if a sequence exceeds read_size.

    threads > 1 (or 0 = one per core) parses row windows in parallel:
    one streaming pass records each window's byte offset, then the
    workers parse disjoint windows directly (ctypes releases the GIL).
    Byte-identical output and fatal semantics (the reported line is the
    global first offender), same as the sequential path.
    """
    lib = load()
    if threads in (None, 0):
        threads = min(os.cpu_count() or 1, 16)
    if threads > 1 and max_pairs >= 4096:
        return _parse_pairs_mt(lib, path, max_pairs, read_size, threads)
    pats = np.zeros((max_pairs, read_size), np.uint8)
    txts = np.zeros((max_pairs, read_size), np.uint8)
    plens = np.zeros(max_pairs, np.int32)
    tlens = np.zeros(max_pairs, np.int32)
    n = lib.aim_parse_pairs(path.encode(), max_pairs, read_size,
                            pats, txts, plens, tlens)
    if n == -1000000000:
        raise FileNotFoundError(path)
    if n < 0:
        # Mirrors the reference's fatal "READ LENGTH less than length of the
        # input reads" (ref: host.c:119-123).
        raise ValueError(
            f"read longer than READ_SIZE={read_size} at line {-n} of {path}")
    return pats[:n], txts[:n], plens[:n], tlens[:n]


def _parse_pairs_mt(lib, path: str, max_pairs: int, read_size: int,
                    threads: int):
    """Window-parallel parse: boundary scan + per-window direct parses
    into disjoint slices of shared output arrays."""
    from concurrent.futures import ThreadPoolExecutor

    step = -(-max_pairs // threads)
    offs = np.zeros(threads, np.int64)
    lines = np.zeros(threads, np.int64)
    total = lib.aim_pair_offsets(path.encode(), step, max_pairs, threads,
                                 offs, lines)
    if total == -1000000000:
        raise FileNotFoundError(path)
    pats = np.zeros((total, read_size), np.uint8)
    txts = np.zeros((total, read_size), np.uint8)
    plens = np.zeros(total, np.int32)
    tlens = np.zeros(total, np.int32)
    if total == 0:
        return pats, txts, plens, tlens

    def work(k):
        lo = k * step
        m = min(step, total - lo)
        if m <= 0:
            return 0
        return lib.aim_parse_pairs_at(
            path.encode(), int(offs[k]), int(lines[k]), m, read_size,
            pats[lo:lo + m], txts[lo:lo + m], plens[lo:lo + m],
            tlens[lo:lo + m])

    with ThreadPoolExecutor(threads) as ex:
        ns = list(ex.map(work, range(threads)))
    bad = [-nk for nk in ns if nk < 0]
    if bad:
        # Each window stops at its own first offender; the smallest line
        # across windows is the global first — identical message to the
        # sequential path.
        raise ValueError(f"read longer than READ_SIZE={read_size} at "
                         f"line {min(bad)} of {path}")
    return pats, txts, plens, tlens


def parse_pairs_range(path: str, start_pair: int, max_pairs: int,
                      read_size: int):
    """Parse only pairs [start_pair, start_pair + max_pairs) of a pair
    file: the seek phase is a newline count (no copies), so a multi-host
    process touches O(its block) of parsing/packing work (the reference
    host streams each DPU's contiguous block, host.c:91-134).  Same
    return contract and fatal READ_SIZE semantics (global line numbers)
    as parse_pairs."""
    lib = load()
    pats = np.zeros((max_pairs, read_size), np.uint8)
    txts = np.zeros((max_pairs, read_size), np.uint8)
    plens = np.zeros(max_pairs, np.int32)
    tlens = np.zeros(max_pairs, np.int32)
    n = lib.aim_parse_pairs_range(path.encode(), start_pair, max_pairs,
                                  read_size, pats, txts, plens, tlens)
    if n == -1000000000:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(
            f"read longer than READ_SIZE={read_size} at line {-n} of {path}")
    return pats[:n], txts[:n], plens[:n], tlens[:n]


def count_pairs(path: str, max_pairs: int) -> int:
    """Count complete pairs in a pair file (newline scan, no parsing),
    capped at max_pairs."""
    lib = load()
    n = lib.aim_count_pairs(path.encode(), max_pairs)
    if n == -1000000000:
        raise FileNotFoundError(path)
    return int(n)


def _prep(pats, txts, plens, tlens):
    return (np.ascontiguousarray(pats, np.uint8),
            np.ascontiguousarray(txts, np.uint8),
            np.ascontiguousarray(plens, np.int32),
            np.ascontiguousarray(tlens, np.int32))


def _run_chunked(n, threads, worker):
    """Run worker(lo, hi) over [0, n) with a thread pool.  ctypes releases
    the GIL during the C calls, so row-chunk parallelism scales; threads=1
    keeps the single-thread semantics (the bench baseline), threads=0
    picks a pool size from the host."""
    if threads in (None, 0):
        threads = min(os.cpu_count() or 1, 16)
    if threads <= 1 or n < 64:
        worker(0, n)
        return
    from concurrent.futures import ThreadPoolExecutor
    step = -(-n // threads)
    spans = [(i * step, min(n, (i + 1) * step)) for i in range(threads)
             if i * step < n]
    with ThreadPoolExecutor(len(spans)) as ex:
        list(ex.map(lambda s: worker(*s), spans))


def nw_align(pats, txts, plens, tlens, *, mismatch, gap_i, gap_d, backtrace,
             threads=1):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_nw_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                         tlens[lo:hi], hi - lo, read_size,
                         mismatch, gap_i, gap_d, int(backtrace),
                         scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def swg_align(pats, txts, plens, tlens, *, match, mismatch, gap_o, gap_e,
              max_score, cell_width, backtrace, threads=1):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_swg_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                          tlens[lo:hi], hi - lo, read_size,
                          match, mismatch, gap_o, gap_e, max_score,
                          cell_width, int(backtrace),
                          scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def wfa_align(pats, txts, plens, tlens, *, mismatch, gap_o, gap_e, max_score,
              adaptive, backtrace, threads=1, overflow_backtrace=False):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_wfa_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                          tlens[lo:hi], hi - lo, read_size,
                          mismatch, gap_o, gap_e, max_score, int(adaptive),
                          int(backtrace), int(overflow_backtrace),
                          scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def nw_traceback_bits(bits, plens, tlens, max_ops):
    """Walk device-produced NW direction bits [n, H, W] u8 into ops buffers."""
    lib = load()
    bits = np.ascontiguousarray(bits, np.uint8)
    n, H, W = bits.shape
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_nw_traceback_bits(bits, H, W, plens, tlens, n, max_ops,
                              ops, begin, end)
    return ops, begin, end


def swg_traceback_bits(bits, plens, tlens, max_ops):
    lib = load()
    bits = np.ascontiguousarray(bits, np.uint8)
    n, H, W = bits.shape
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_swg_traceback_bits(bits, H, W, plens, tlens, n, max_ops,
                               ops, begin, end)
    return ops, begin, end


def wfa_backtrace_batch(hist_m, hist_i, hist_d, klo, khi, flags, scores,
                        pats, txts, plens, tlens, *, mismatch, gap_o, gap_e,
                        max_score):
    """Walk device-produced dense WFA histories into ops buffers.

    Layout: hist [n, S+1, K] int16 (views with dense k rows are walked via
    their strides, no copy), klo/khi/flags [n, S+1].
    """
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size

    def prep16(a):
        # Views are fine (e.g. lane slices of a packed transfer buffer):
        # the C walker takes element strides; only the k rows must be dense.
        a = np.asarray(a)
        assert a.dtype == np.int16 and a.strides[-1] == a.itemsize, \
            (a.dtype, a.shape, a.strides)
        return a

    hist_m, hist_i, hist_d = prep16(hist_m), prep16(hist_i), prep16(hist_d)
    klo = np.ascontiguousarray(klo, np.int32)
    khi = np.ascontiguousarray(khi, np.int32)
    flags = np.ascontiguousarray(flags, np.uint8)
    scores = np.ascontiguousarray(scores, np.int32)
    h_pair, h_score = [x // hist_m.itemsize for x in hist_m.strides[:2]]
    m_pair, m_score = flags.shape[1], 1
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_wfa_backtrace_batch(hist_m, hist_i, hist_d, klo, khi, flags,
                                scores, pats, txts, plens, tlens, n,
                                read_size, mismatch, gap_o, gap_e, max_score,
                                h_pair, h_score, m_pair, m_score,
                                ops, begin, end)
    return ops, begin, end


def emit_output(path, idx, scores, ops, begin, end, backtrace):
    """Write the reference-format output file (ref: host.c:332-353)."""
    lib = load()
    idx = np.ascontiguousarray(idx, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    if ops is None:
        ops = np.zeros((len(scores), 1), np.uint8)
        begin = np.zeros(len(scores), np.int32)
        end = np.zeros(len(scores), np.int32)
    ops = np.ascontiguousarray(ops, np.uint8)
    begin = np.ascontiguousarray(begin, np.int32)
    end = np.ascontiguousarray(end, np.int32)
    max_ops = ops.shape[1]
    n = len(scores)
    r = lib.aim_emit_output(path.encode(), idx, scores, ops, begin, end, n,
                            max_ops, int(backtrace))
    if r < 0:
        raise IOError(f"cannot write {path}")
    return r


def genasm_align(pats, txts, plens, tlens, *, max_score, backtrace,
                 threads=1):
    """GenASM host semantics: CLEAN bounded Levenshtein distance + the NW
    walker's D -> I -> diagonal priority on a proper 2-D table (see
    golden/genasm.py and oracle.cpp aim_genasm_align for the anchoring
    argument).  Distances above max_score report max_score+1 with the
    default "M" CIGAR (the framework's WFA overflow convention)."""
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_genasm_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                             tlens[lo:hi], hi - lo, read_size, max_score,
                             int(backtrace), scores[lo:hi], ops[lo:hi],
                             begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end
