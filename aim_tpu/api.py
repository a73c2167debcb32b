"""High-level alignment API: batches, device tiers, fallback, traceback.

This is the framework's equivalent of the reference host orchestrator
(ref: WFA/DPU-MRAM/host/host.c:136-377): pack pairs -> push to device ->
run the batch kernel -> pull results -> reconstruct CIGARs -> emit.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import jax
import numpy as np

from aim_tpu.config import (ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA,
                            AlignConfig)
from aim_tpu import native

_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is
    set (JAX reads it itself), else a fixed directory in the checkout
    (the path is part of the cache key, so it must not move)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


@dataclass
class AlignResult:
    scores: np.ndarray                 # [n] int32
    ops: np.ndarray | None = None      # [n, 2R] uint8 (backtrace only)
    begin: np.ndarray | None = None    # [n] int32
    end: np.ndarray | None = None      # [n] int32
    # phase timings (seconds), mirroring the reference's CPU-DPU /
    # DPU Kernel / DPU-CPU phases (ref: host.c:272,299,330)
    t_load: float = 0.0
    t_kernel: float = 0.0
    t_retrieve: float = 0.0
    n_fallback: int = 0  # pairs served by the exact host oracle
    n_devices: int = 1   # cards the batches were sharded over
    # Measured host-side energy over the whole align() span (J), from
    # RAPL powercap counters when the host exposes them; None otherwise.
    energy_measured_j: float | None = None


_BUDGET_LOGGED = False


def _forward_fn(cfg: AlignConfig):
    """The device tier for cfg's algorithm.  GenASM is NW at unit costs
    without the reference's tape aliasing (golden/genasm.py), served by
    the NW kernel in its GenASM mode."""
    if cfg.algo in (ALGO_NW, ALGO_GENASM):
        from aim_tpu.ops.nw_xla import nw_forward
        return nw_forward
    if cfg.algo == ALGO_SWG:
        from aim_tpu.ops.swg_xla import swg_forward
        return swg_forward
    from aim_tpu.ops.wfa_xla import wfa_forward
    return wfa_forward


def _pad_batch(arrs, size):
    n = arrs[0].shape[0]
    if n == size:
        return arrs
    out = []
    for a in arrs:
        pad = [(0, size - n)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out


def _oracle_align(pats, txts, plens, tlens, cfg: AlignConfig):
    """Exact-semantics host path (used for flagged-pair fallback);
    threads=0 sizes a pool from the host — flagged batches can be large
    and the per-pair work is embarrassingly parallel."""
    if cfg.algo == ALGO_NW:
        return native.nw_align(pats, txts, plens, tlens,
                               mismatch=cfg.mismatch, gap_i=cfg.gap_i,
                               gap_d=cfg.gap_d, backtrace=cfg.backtrace,
                               threads=0)
    if cfg.algo == ALGO_SWG:
        return native.swg_align(pats, txts, plens, tlens, match=cfg.match,
                                mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                                gap_e=cfg.gap_e, max_score=cfg.max_score,
                                cell_width=cfg.cell_width,
                                backtrace=cfg.backtrace, threads=0)
    if cfg.algo == ALGO_GENASM:
        return native.genasm_align(pats, txts, plens, tlens,
                                   max_score=cfg.max_score,
                                   backtrace=cfg.backtrace, threads=0)
    return native.wfa_align(pats, txts, plens, tlens, mismatch=cfg.mismatch,
                            gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                            max_score=cfg.max_score, adaptive=cfg.adaptive,
                            backtrace=cfg.backtrace, threads=0)


def _device_memory_budget(default_bytes=2 << 30) -> int:
    """Per-device memory budget for alignment state: half of the device's
    reported memory limit (leaves room for XLA temporaries, double
    buffering, and the framework's own outputs), with a conservative
    fallback when the runtime exposes no stats (CPU meshes report none).
    The analogue of the reference's 64 MB MRAM capacity constant
    (ref: common/mram-management.h:27 DPU_CAPACITY).

    Logs (once) which budget was chosen: the batch cap silently means
    something different on a stats-less CPU mesh vs a real card."""
    global _BUDGET_LOGGED
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if limit and limit > 0:
        if not _BUDGET_LOGGED:
            _BUDGET_LOGGED = True
            print(f"device memory budget: {int(limit) // 2 >> 20} MiB "
                  "(half the runtime-reported limit)", file=sys.stderr)
        return int(limit) // 2
    if not _BUDGET_LOGGED:
        _BUDGET_LOGGED = True
        print(f"device memory budget: {default_bytes >> 20} MiB "
              "(no runtime memory stats — conservative default)",
              file=sys.stderr)
    return default_bytes


def per_pair_bytes(cfg: AlignConfig) -> int:
    """Device bytes one pair costs in a compiled step: every buffer that
    scales with the batch (inputs, tables, scan temporaries, outputs).
    An upper bound on compiled.memory_analysis() per pair, with a margin
    of 1.3-1.7x over what an H100 compile takes at the long-read cells
    (PERF.md; the gpu-marked tests check it on the card)."""
    R = cfg.read_size
    if cfg.algo == ALGO_WFA:
        K = 2 * cfg.max_score + 1
        # next-mismatch table build (byte gather, int32 keys, scan
        # temporaries, the int16 table) + history and its packed copy
        return 5 * K * (R + 1) + 12 * (cfg.max_score + 2) * K + 4 * R
    if cfg.backtrace:
        # stacked direction codes, their transposed copy, packed output
        return 2 * (R + 1) * (R + 1) + 64 * (R + 1)
    return 64 * (R + 1)


def _memory_batch_cap(cfg: AlignConfig, budget_bytes=None) -> int:
    """Cap the device batch by per-pair device footprint — the analogue
    of the reference launchers' MRAM-fit shrink loops
    (ref: run-nw-pim-mram.py:87-96)."""
    if budget_bytes is None:
        budget_bytes = _device_memory_budget()
    return max(256, budget_bytes // per_pair_bytes(cfg))


@functools.lru_cache(maxsize=64)
def _make_unfuse(bs, p_cols, t_cols):
    """Device-side splitter for the fused-upload layout: one uint8 host
    buffer [pats | txts | plens | tlens] per chunk becomes the four
    kernel inputs via static slices + a bitcast for the int32 lengths.
    One jit specialization per align() call (chunk shapes are constant).
    """
    import jax.numpy as jnp

    psz = bs * p_cols
    tsz = bs * t_cols
    lsz = bs * 4

    @jax.jit
    def unfuse(buf):
        o = 0
        pats = buf[o:o + psz].reshape(bs, p_cols); o += psz
        txts = buf[o:o + tsz].reshape(bs, t_cols); o += tsz
        plens = jax.lax.bitcast_convert_type(
            buf[o:o + lsz].reshape(bs, 4), jnp.int32); o += lsz
        tlens = jax.lax.bitcast_convert_type(
            buf[o:o + lsz].reshape(bs, 4), jnp.int32)
        return pats, txts, plens, tlens

    return unfuse


def _fuse_chunk(cp, ct, cpl, ctl):
    return np.concatenate([
        np.ascontiguousarray(cp).reshape(-1),
        np.ascontiguousarray(ct).reshape(-1),
        np.ascontiguousarray(cpl.astype(np.int32, copy=False))
        .view(np.uint8).reshape(-1),
        np.ascontiguousarray(ctl.astype(np.int32, copy=False))
        .view(np.uint8).reshape(-1)])


def _plan_bs(cfg: AlignConfig, n: int, ndev: int):
    """Device chunk size + alignment: one jit specialization per run,
    capped by the per-pair device footprint (the reference launchers'
    MRAM-fit shrink-loop analogue) and rounded to the mesh alignment."""
    align_to = max(8, 8 * ndev)
    bs = min(cfg.batch_pairs, _memory_batch_cap(cfg),
             -(-n // align_to) * align_to)
    return max(-(-bs // align_to) * align_to, align_to), align_to


def _deal_order(order, n: int, bs: int, ndev: int):
    """Shard-aware dealing of a difficulty-sorted order: within each
    device chunk, sorted pairs are dealt round-robin
    across the ndev contiguous device blocks, so every shard gets a
    balanced difficulty mix (a contiguously sharded globally-sorted
    batch would hand one device all the hardest pairs and the dispatch
    would wait on it) while each block stays internally sorted — the
    tile-grouping win the sort exists for (SURVEY §7.3)."""
    perm = np.empty(n, dtype=order.dtype)
    blk = max(1, bs // ndev)
    for c0 in range(0, n, bs):
        m = min(bs, n - c0)
        band = order[c0:c0 + m]
        pos = np.arange(m)
        # Dealing order: visit chunk positions by (slot-within-block,
        # block) so turn j lands in block j % ndev at slot j // ndev.
        deal = np.lexsort((pos // blk, pos % blk))
        perm[c0 + deal] = band
    return perm


def _difficulty_order(pats, txts, plens, tlens):
    """Stable ascending sort order by a cheap edit-distance proxy
    (subsampled diagonal Hamming count + length skew).  Grouping
    similar-difficulty pairs into the same kernel tile lets each tile's
    while-loop exit at ITS hardest pair instead of the batch-wide tail —
    the mitigation SURVEY §7.3 names for per-pair termination divergence
    ("sort pairs by estimated difficulty within a batch; keep output
    order via idx").  Column subsampling (<= 512 sampled positions)
    keeps the host pass cheap at long read lengths."""
    pl = np.asarray(plens).astype(np.int64)
    tl = np.asarray(tlens).astype(np.int64)
    step = max(1, pats.shape[1] // 512)
    pos = np.arange(0, pats.shape[1], step)
    valid = pos[None, :] < np.minimum(pl, tl)[:, None]
    ham = ((pats[:, pos] != txts[:, pos]) & valid).sum(1).astype(np.int64)
    return np.argsort(ham * step + np.abs(pl - tl), kind="stable")


def align(pats, txts, plens, tlens, cfg: AlignConfig,
          device_sharding=None) -> AlignResult:
    """Align a packed pair batch.  Returns scores (+ ops buffers when
    cfg.backtrace).  Device work runs in cfg.batch_pairs chunks.

    AIM_TPU_SORT=1 runs the device work in estimated-difficulty order
    (output order is restored — the pair idx contract is unchanged).
    Default: ON for long-read configs (read_size >= 1024, where a
    chunk's score loop rides to its hardest pair, so grouping similar
    scores into one chunk shortens the others), OFF for short reads.
    AIM_TPU_SORT=0 force-disables, =1 force-enables.
    Under sharding the sorted order is dealt round-robin across the
    device blocks of each chunk (see _deal_order): every shard keeps a
    balanced difficulty mix, every block stays internally sorted."""
    sort_env = os.environ.get("AIM_TPU_SORT", "")
    sort_on = sort_env == "1" if sort_env in ("0", "1") \
        else cfg.read_size >= 1024
    sort = sort_on and len(np.asarray(plens)) > 128
    if sort:
        t0 = time.perf_counter()
        order = _difficulty_order(pats, txts, plens, tlens)
        ndev = getattr(device_sharding, "num_devices", None) or 1
        if ndev > 1:
            n = len(order)
            bs, _ = _plan_bs(cfg, n, ndev)
            order = _deal_order(order, n, bs, ndev)
        t_sort = time.perf_counter() - t0
        res = _align_impl(pats[order], txts[order],
                          np.asarray(plens)[order],
                          np.asarray(tlens)[order], cfg, device_sharding)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return AlignResult(
            res.scores[inv],
            res.ops[inv] if res.ops is not None else None,
            res.begin[inv] if res.begin is not None else None,
            res.end[inv] if res.end is not None else None,
            t_load=res.t_load + t_sort, t_kernel=res.t_kernel,
            t_retrieve=res.t_retrieve, n_fallback=res.n_fallback)
    return _align_impl(pats, txts, plens, tlens, cfg, device_sharding)


def _align_impl(pats, txts, plens, tlens, cfg: AlignConfig,
                device_sharding=None) -> AlignResult:
    cfg.validate()
    n = pats.shape[0]
    max_ops = 2 * cfg.read_size
    fwd = _forward_fn(cfg)

    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8) if cfg.backtrace else None
    begin = np.zeros(n, np.int32) if cfg.backtrace else None
    end = np.zeros(n, np.int32) if cfg.backtrace else None
    res = AlignResult(scores, ops, begin, end)

    # Constant per-chunk shape (one jit specialization); padded tail pairs
    # have zero lengths and finish immediately.
    ndev = getattr(device_sharding, "num_devices", None) or 1
    res.n_devices = ndev
    bs, _ = _plan_bs(cfg, n, ndev)

    def put(a):
        return jax.device_put(a) if device_sharding is None \
            else jax.device_put(a, device_sharding)

    # Default transport: upload a wave -> execute-and-block each chunk ->
    # one batched pull, so each phase has its own time (t_load /
    # t_kernel / t_retrieve).  The reference is strictly sequential too
    # (one push, one launch, one pull - host.c:246-326).
    starts = list(range(0, n, bs))

    # Fused-upload transport (opt-in, AIM_TPU_FUSED_UPLOAD=1): one uint8
    # H2D buffer per chunk, split on device — one transfer plus one small
    # device dispatch in place of four transfers.  Single-device only (a
    # flat byte buffer has no meaningful "pairs" sharding).
    fuse = (os.environ.get("AIM_TPU_FUSED_UPLOAD", "0") == "1"
            and device_sharding is None)
    unfuse = _make_unfuse(bs, pats.shape[1], txts.shape[1]) \
        if fuse else None

    # Overlapped transport (opt-in, AIM_TPU_OVERLAP=1): the host never
    # blocks between dispatches, so the runtime can pipeline wave w+1's
    # H2D copies with wave w's kernels; it only blocks to pull results
    # (2-wave backpressure bounds device memory to the same scale as the
    # sequential path).
    overlap = os.environ.get("AIM_TPU_OVERLAP", "0") == "1"

    # Rolling waves bound host+device memory on very large runs while
    # keeping the per-wave upload-all -> execute-each -> pull-once shape.
    WAVE = 8
    hosts = []

    def upload_chunk(lo):
        chunk = slice(lo, min(lo + bs, n))
        cp, ct, cpl, ctl = _pad_batch(
            [pats[chunk], txts[chunk], plens[chunk], tlens[chunk]], bs)
        if fuse:
            return unfuse(put(_fuse_chunk(cp, ct, cpl, ctl)))
        return (put(cp), put(ct), put(cpl), put(ctl))

    if overlap:
        # Dispatch every chunk without blocking and pull wave w-1 while
        # wave w runs.  The three phases overlap here, so there is no
        # honest per-phase split: the WHOLE pipelined span is booked to
        # t_kernel (the device is busy throughout — also what the energy
        # estimate and device log should see), t_load/t_retrieve stay 0.
        t0 = time.perf_counter()
        pending = []
        for w0 in range(0, len(starts), WAVE):
            outs = []
            for lo in starts[w0:w0 + WAVE]:
                outs.append(fwd(*upload_chunk(lo), cfg=cfg))
            pending.append(outs)
            if len(pending) > 1:
                flat, tree = jax.tree.flatten(pending.pop(0))
                hosts.extend(jax.tree.unflatten(tree, jax.device_get(flat)))
        for done in pending:
            flat, tree = jax.tree.flatten(done)
            hosts.extend(jax.tree.unflatten(tree, jax.device_get(flat)))
        res.t_kernel += time.perf_counter() - t0
    else:
        for w0 in range(0, len(starts), WAVE):
            wave = starts[w0:w0 + WAVE]
            t0 = time.perf_counter()
            uploads = []
            for lo in wave:
                up = upload_chunk(lo)
                if fuse:
                    # split now and drop the fused buffer before the
                    # next upload
                    jax.block_until_ready(up)
                uploads.append(up)
            jax.block_until_ready(uploads)
            res.t_load += time.perf_counter() - t0

            outs = []
            for (dp, dt, dpl, dtl) in uploads:
                t1 = time.perf_counter()
                out = fwd(dp, dt, dpl, dtl, cfg=cfg)
                jax.block_until_ready(out)
                res.t_kernel += time.perf_counter() - t1
                outs.append(out)
            del uploads

            t2 = time.perf_counter()
            flat, tree = jax.tree.flatten(outs)
            host_flat = jax.device_get(flat)
            hosts.extend(jax.tree.unflatten(tree, host_flat))
            res.t_retrieve += time.perf_counter() - t2
            del outs

    for lo, out in zip(starts, hosts):
        hi = min(lo + bs, n)
        chunk = slice(lo, hi)
        host = {k: np.ascontiguousarray(v)[:hi - lo] for k, v in out.items()}
        scores[chunk] = host["scores"]
        if cfg.backtrace:
            if cfg.algo == ALGO_WFA:
                # Unpack the two transfer arrays into strided views (the
                # walker takes element strides; no host copies of the hist).
                ph, pm = host["packed_hist"], host["packed_meta"]
                K = 2 * cfg.max_score + 1
                o, b, e = native.wfa_backtrace_batch(
                    ph[:, :, :K], ph[:, :, K:2 * K], ph[:, :, 2 * K:3 * K],
                    pm[:, :, 0].astype(np.int32),
                    pm[:, :, 1].astype(np.int32),
                    pm[:, :, 2].astype(np.uint8), host["scores"],
                    pats[chunk], txts[chunk], plens[chunk], tlens[chunk],
                    mismatch=cfg.mismatch, gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                    max_score=cfg.max_score)
            else:
                walker = (native.swg_traceback_bits if cfg.algo == ALGO_SWG
                          else native.nw_traceback_bits)
                o, b, e = walker(host["bits"], plens[chunk], tlens[chunk],
                                 max_ops)
            ops[chunk], begin[chunk], end[chunk] = o, b, e
        # Flagged pairs (tape aliasing beyond plen == tlen+1, potential
        # cell-type wrap) are re-run through the exact host oracle.
        fb = host.get("needs_fallback")
        if fb is not None and fb.any():
            sel = np.nonzero(fb)[0]
            res.n_fallback += len(sel)
            osc, oops, ob, oe = _oracle_align(
                pats[chunk][sel], txts[chunk][sel], plens[chunk][sel],
                tlens[chunk][sel], cfg)
            scores[lo + sel] = osc
            if cfg.backtrace:
                ops[lo + sel] = oops
                begin[lo + sel] = ob
                end[lo + sel] = oe
    if cfg.algo == ALGO_GENASM and cfg.backtrace:
        # GenASM overflow (distance > k, reported as k+1 by the kernel)
        # emits the default one-op "M" CIGAR, as the host oracle does.
        over = np.nonzero(scores > cfg.max_score)[0]
        ops[over] = ord("M")
        end[over] = np.asarray(plens)[over] + np.asarray(tlens)[over]
        begin[over] = end[over] - 1
    return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)


def _overflow_bt_pass(pats, txts, plens, tlens, cfg: AlignConfig,
                      res: AlignResult) -> AlignResult:
    """Opt-in WFA WRAM-variant overflow-backtrace compat
    (cfg.overflow_backtrace): overflowed pairs (score > MAX_SCORE, which
    every tier leaves CIGAR-less per the MRAM behavior) get a defined
    best-effort CIGAR from the host oracle's compat rendition.  Scores
    are unchanged; launcher-derived configs overflow rarely by design,
    so this pass is host-cheap."""
    if not (cfg.algo == ALGO_WFA and cfg.backtrace
            and cfg.overflow_backtrace):
        return res
    sel = np.nonzero(res.scores > cfg.max_score)[0]
    if not len(sel):
        return res
    plens = np.asarray(plens)
    tlens = np.asarray(tlens)
    _, oops, ob, oe = native.wfa_align(
        pats[sel], txts[sel], plens[sel], tlens[sel],
        mismatch=cfg.mismatch, gap_o=cfg.gap_o, gap_e=cfg.gap_e,
        max_score=cfg.max_score, adaptive=cfg.adaptive, backtrace=True,
        threads=0, overflow_backtrace=True)
    res.ops[sel] = oops
    res.begin[sel] = ob
    res.end[sel] = oe
    return res


def _read_energy_uj():
    """Best-effort host energy counters (RAPL powercap, package+DRAM
    domains summed).  Returns None when the host exposes none (typical in
    containers).  The closest reachable analogue of the reference's
    UPMEM dpu_probe DIMM-rank counters (ref: host.c:62-67,285-296)."""
    import glob
    total, found = 0, False
    try:
        for p in glob.glob("/sys/class/powercap/*/energy_uj"):
            with open(p) as f:
                total += int(f.read().strip())
            found = True
    except (OSError, ValueError):
        return None
    return total if found else None


@functools.lru_cache(maxsize=1)
def card_power_limits_w() -> tuple[float, ...]:
    """Every card's power limit in watts, in nvidia-smi's order; empty
    when they cannot be read (no card, no nvidia-smi)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return tuple(float(w) for w in r.stdout.split()) \
            if r.returncode == 0 else ()
    except (OSError, subprocess.SubprocessError, ValueError):
        return ()


def energy_estimate_joules(res: AlignResult) -> float | None:
    """Energy-probe substitute (ref: host.c:62-67,285-296 -DENERGY uses
    UPMEM dpu_probe counters): kernel-phase seconds x the summed power
    limits of the res.n_devices cards the run used — an upper-bound
    estimate, labeled as such.  None when those limits cannot be read;
    no wattage is assumed."""
    watts = card_power_limits_w()[:res.n_devices]
    if len(watts) < res.n_devices:
        return None
    return res.t_kernel * sum(watts)


def _energy_text(res: AlignResult) -> str:
    e = energy_estimate_joules(res)
    return "n/a" if e is None else f"{e:.3f}"


def write_device_log(path: str, cfg: AlignConfig, res: AlignResult, n: int):
    """The dpu-out analogue (ref: host.c:355-362 harvests per-DPU logs):
    one line per device with its share of the run."""
    devs = jax.devices()
    with open(path, "w") as f:
        for i, d in enumerate(devs):
            f.write(f"device {i}: {d.platform} {d.device_kind} | "
                    f"algo={cfg.algo} "
                    f"max_score={cfg.max_score} read_size={cfg.read_size} "
                    f"backtrace={cfg.backtrace} adaptive={cfg.adaptive} "
                    f"pairs={n} load_s={res.t_load:.6f} "
                    f"kernel_s={res.t_kernel:.6f} "
                    f"retrieve_s={res.t_retrieve:.6f} "
                    f"fallback={res.n_fallback} "
                    f"energy_est_J={_energy_text(res)}\n")


def align_file(input_path: str, output_path: str, n_reads: int,
               cfg: AlignConfig, device_sharding=None, verbose=True,
               device_log: str | None = None, energy: bool = False,
               profile_dir: str | None = None):
    """Full file-to-file pipeline (the reference host main(), host.c:136).

    n_reads follows the reference CLI meaning: number of PAIRS requested;
    fewer are aligned if the file is shorter (get_reads tolerates EOF,
    ref: host.c:104-110).

    profile_dir: when set, a jax.profiler trace of the device phases is
    written there (TensorBoard-loadable) — the analogue of the
    reference's -DENERGY/probe instrumentation (SURVEY §5.1).
    """
    t0 = time.perf_counter()
    # threads=0: one parse window per core (single-core hosts take the
    # sequential path unchanged).
    pats, txts, plens, tlens = native.parse_pairs(input_path, n_reads,
                                                  cfg.read_size, threads=0)
    t_parse = time.perf_counter() - t0
    e0 = _read_energy_uj() if energy else None
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            res = align(pats, txts, plens, tlens, cfg, device_sharding)
    else:
        res = align(pats, txts, plens, tlens, cfg, device_sharding)
    if e0 is not None:
        e1 = _read_energy_uj()
        if e1 is not None and e1 >= e0:  # ignore counter wraparound
            res.energy_measured_j = (e1 - e0) / 1e6
    n = len(res.scores)
    idx = np.arange(n, dtype=np.int32)
    native.emit_output(output_path, idx, res.scores, res.ops, res.begin,
                       res.end, cfg.backtrace)
    if device_log:
        write_device_log(device_log, cfg, res, n)
    if verbose:
        # Phase prints mirroring the reference (ref: host.c:272,299,330).
        print(f"Parsed {n} pairs in {t_parse * 1e3:.3f} ms")
        print(f"Host-to-device: {res.t_load * 1e3:f} ms")
        print(f"Device kernel: {res.t_kernel * 1e3:f} ms")
        print(f"Device-to-host: {res.t_retrieve * 1e3:f} ms")
        total = res.t_load + res.t_kernel + res.t_retrieve
        if total > 0:
            print(f"pairs/s (device phases): {n / total:.1f}")
        if energy:
            # ref: host.c:285-296 prints "DPU Kernel Energy (J): ..."
            e = energy_estimate_joules(res)
            print("Device kernel energy (J, estimated at the cards' power "
                  "limits): " + ("not available: the cards' power limits "
                                 "cannot be read" if e is None else f"{e:f}"))
            if res.energy_measured_j is not None:
                print(f"Host Energy (J, measured, RAPL package+DRAM over "
                      f"the align span): {res.energy_measured_j:f}")
        print(f"host-oracle fallback pairs: {res.n_fallback}")
    return res
