"""Multi-host job runner: contiguous pair sharding across processes.

The reference host feeds contiguous pair blocks to DPUs in file order and
emits results in the same order (ref: host.c:191-209, 332-353).  The
multi-host analogue: each process parses only its contiguous pair range
(global idx = file order preserved), aligns it on its local devices, writes
an output part, and process 0 concatenates the parts — an ordered gather
over the filesystem rather than a collective, since the result stream is
bulk text.
Device-level (intra-host) parallelism uses the pairs mesh (see mesh.py).
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from aim_tpu import native
from aim_tpu.config import AlignConfig
from aim_tpu.parallel.mesh import make_mesh, pair_sharding, shard_range


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None):
    """jax.distributed bootstrap.  Nothing tells JAX of a cluster, so the
    coordinator ("host:port"), process count and id are always explicit.

    One process per card on a shared host: pass that card's index as
    local_device_ids (or start the process with CUDA_VISIBLE_DEVICES set
    to it).  A GPU process reserves most of the memory of every card it
    sees when it starts, so two processes that both see a card cannot
    both run on it."""
    import jax
    if num_processes is None or num_processes <= 1:
        return 0, 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return jax.process_index(), jax.process_count()


def align_file_multihost(input_path: str, output_path: str, n_reads: int,
                         cfg: AlignConfig, process_id: int = 0,
                         n_processes: int = 1, verbose=True):
    """Per-process slice of the file-to-file pipeline.

    Returns (n_local, timings). Process 0 performs the final ordered
    concatenation once all parts exist.
    """
    from aim_tpu.api import align

    # Each process parses only its contiguous block: the shard bounds
    # come from a newline-count pass (no copies), then the range parser
    # packs just [lo, hi) — O(block) host work per process.
    total = native.count_pairs(input_path, n_reads)
    lo, hi = shard_range(total, process_id, n_processes)
    pats, txts, plens, tlens = native.parse_pairs_range(
        input_path, lo, hi - lo, cfg.read_size)
    import jax
    local = [d for d in jax.devices() if d.process_index == jax.process_index()] \
        if n_processes > 1 else jax.devices()
    sharding = pair_sharding(make_mesh(devices=local)) if len(local) > 1 else None

    res = align(pats, txts, plens, tlens, cfg,
                device_sharding=sharding)
    idx = np.arange(lo, hi, dtype=np.int32)  # global pair idx (file order)
    part = output_path + (f".part{process_id}" if n_processes > 1 else "")
    # Write-then-rename so a part file only ever EXISTS complete: emit to a
    # temp name and atomically rename (emit_output creates the file on open,
    # so waiting on the final name alone would race a half-written part).
    tmp = part + ".tmp"
    native.emit_output(tmp, idx, res.scores, res.ops, res.begin, res.end,
                       cfg.backtrace)
    os.replace(tmp, part)
    if n_processes > 1 and process_id == 0:
        _concat_parts(output_path, n_processes)
    if verbose:
        print(f"[host {process_id}] pairs {lo}..{hi} "
              f"load={res.t_load:.3f}s kernel={res.t_kernel:.3f}s "
              f"retrieve={res.t_retrieve:.3f}s fallback={res.n_fallback}")
    return hi - lo, res


def _concat_parts(output_path: str, n_processes: int, timeout_s=600):
    """Ordered gather of the per-process part files.  Parts appear
    atomically (temp-write + os.replace above), so existence == complete."""
    parts = [f"{output_path}.part{p}" for p in range(n_processes)]
    deadline = time.time() + timeout_s
    for p in parts:
        while not os.path.exists(p):
            if time.time() > deadline:
                raise TimeoutError(f"missing output part {p}")
            time.sleep(0.2)
    with open(output_path, "wb") as out:
        for p in parts:
            # Chunked copy: a 10^7-pair backtrace run makes multi-GB
            # parts; keep concatenation constant-memory.
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, length=8 << 20)
            os.remove(p)
