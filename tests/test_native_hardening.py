"""Defensive behavior of the native runtime: its build rule and the
parallel parsers."""

import ctypes
import os

import numpy as np

import aim_tpu.native as nat


def test_native_build_keyed_on_source_hash(tmp_path, monkeypatch):
    """A checkout gives the source and a stale library the same mtime, so
    the build is keyed on the source's hash: an edit rebuilds, a touch
    does not."""
    src = tmp_path / "probe.cpp"
    so = tmp_path / "probe.so"
    src.write_text('extern "C" int probe() { return 1; }\n')
    monkeypatch.setattr(nat, "_SRC", str(src))
    monkeypatch.setattr(nat, "_SO", str(so))
    assert nat._build() == str(so)
    assert ctypes.CDLL(str(so)).probe() == 1
    built = os.stat(so).st_mtime_ns
    os.utime(src, ns=(built + 10**9, built + 10**9))  # newer, same bytes
    nat._build()
    assert os.stat(so).st_mtime_ns == built
    src.write_text('extern "C" int probe() { return 2; }\n')
    os.utime(src, ns=(built - 10**9, built - 10**9))  # older, new bytes
    nat._build()
    assert os.stat(so).st_mtime_ns != built
    fresh = tmp_path / "probe2.so"  # a new path: dlopen caches by path
    fresh.write_bytes(so.read_bytes())
    assert ctypes.CDLL(str(fresh)).probe() == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_parse_pairs_range_matches_full(tmp_path):
    """Range parser == full parse on every window, incl. ragged tails,
    missing trailing newline, and the fatal READ_SIZE line number."""
    import os
    p = tmp_path / "pairs.txt"
    lines = []
    rng = __import__("random").Random(5)
    seqs = []
    for i in range(7):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 12)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 12)))
        seqs.append((a, b))
        lines += [">" + a, "<" + b]
    p.write_text("\n".join(lines) + "\n")
    full = nat.parse_pairs(str(p), 100, 16)
    assert len(full[2]) == 7
    for start in range(0, 9):
        for count in range(0, 9):
            sub = nat.parse_pairs_range(str(p), start, count, 16)
            got = len(sub[2])
            assert got == max(0, min(count, 7 - start))
            for j in range(got):
                np.testing.assert_array_equal(sub[0][j], full[0][start + j])
                np.testing.assert_array_equal(sub[1][j], full[1][start + j])
                assert sub[2][j] == full[2][start + j]
                assert sub[3][j] == full[3][start + j]
    assert nat.count_pairs(str(p), 100) == 7
    assert nat.count_pairs(str(p), 3) == 3

    # no trailing newline: getline-style length drops the final char,
    # identically in both parsers
    p2 = tmp_path / "pairs2.txt"
    p2.write_text(">ACGT\n<TTAA")
    f2 = nat.parse_pairs(str(p2), 10, 16)
    r2 = nat.parse_pairs_range(str(p2), 0, 10, 16)
    np.testing.assert_array_equal(f2[1], r2[1])
    assert list(f2[3]) == list(r2[3]) == [3]
    assert nat.count_pairs(str(p2), 10) == 1

    # fatal READ_SIZE reject: same global line number from both parsers,
    # also when the seek phase skipped past earlier pairs
    p3 = tmp_path / "pairs3.txt"
    p3.write_text(">AA\n<CC\n>" + "A" * 40 + "\n<GG\n")
    import pytest
    with pytest.raises(ValueError, match="line 4"):
        nat.parse_pairs(str(p3), 10, 16)
    with pytest.raises(ValueError, match="line 4"):
        nat.parse_pairs_range(str(p3), 1, 10, 16)
    os.unlink(str(p3))


def test_parse_pairs_threads_matches_sequential(tmp_path):
    """Window-parallel parse: byte-identical arrays
    and identical fatal semantics vs the sequential path, across thread
    counts and ragged totals (the 4096-pair gate is bypassed by calling
    the MT helper directly for small files)."""
    import aim_tpu.native as nat2
    rng = __import__("random").Random(11)
    p = tmp_path / "mt.txt"
    lines = []
    n = 1000
    for i in range(n):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 14)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 14)))
        lines += [">" + a, "<" + b]
    p.write_text("\n".join(lines) + "\n")
    seq = nat2.parse_pairs(str(p), n, 16)
    lib = nat2.load()
    for threads in (2, 3, 7):
        mt = nat2._parse_pairs_mt(lib, str(p), n, 16, threads)
        for a, b in zip(seq, mt):
            np.testing.assert_array_equal(a, b)
    # over-ask tolerated (EOF), like the sequential parser
    mt = nat2._parse_pairs_mt(lib, str(p), n + 500, 16, 4)
    assert len(mt[2]) == n
    np.testing.assert_array_equal(seq[0], mt[0])

    # fatal READ_SIZE: the reported line is the GLOBAL first offender
    # even when a later window contains another offender
    bad = tmp_path / "mt_bad.txt"
    rows = [">AA", "<CC"] * 300
    rows[100] = ">" + "A" * 40          # pattern of pair 50 (lines 101/102)
    rows[500] = "<" + "G" * 40          # a later offender in another window
    bad.write_text("\n".join(rows) + "\n")
    import pytest
    # the parser reports after consuming BOTH lines of the pair: line 102
    with pytest.raises(ValueError, match="line 102"):
        nat2._parse_pairs_mt(lib, str(bad), 300, 16, 4)
    with pytest.raises(ValueError, match="line 102"):
        nat2.parse_pairs(str(bad), 300, 16)


def test_parse_pairs_threads_zero_autoscale(tmp_path):
    """threads=0 sizes the pool from the host and still round-trips
    (on a 1-core host it takes the sequential path)."""
    import aim_tpu.native as nat2
    p = tmp_path / "auto.txt"
    p.write_text(">ACGT\n<ACGT\n" * 5000)
    a = nat2.parse_pairs(str(p), 5000, 8, threads=0)
    b = nat2.parse_pairs(str(p), 5000, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
