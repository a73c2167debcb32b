"""aim-tpu: a batch pairwise sequence alignment framework in JAX.

Re-implements the capabilities of the AIM processing-in-memory aligner
(reference: safaad/aim) as a JAX/XLA framework:

  * NW  edit-distance (linear gap) alignment        [ref: NW/*/dpu/nw.c]
  * SWG affine-gap (Gotoh) global alignment          [ref: SWG/*/dpu/swg.c]
  * WFA / WFA-adaptive wavefront alignment           [ref: WFA/*/dpu/wfa.c]
  * GenASM bounded edit distance (served by the NW kernel at unit costs)

Each with optional traceback emitting ``(pair-idx, score, CIGAR)`` records
that are byte-identical to the reference host's output files
(ref: WFA/DPU-MRAM/host/host.c:332-353).

Architecture:
  * pairs are packed into static-shape ``[n, READ_SIZE]`` uint8 device
    arrays (the reference's per-DPU MRAM buffers, host.c:201-209);
  * the per-pair DP runs as vectorized row-scan / wavefront kernels
    across a pair batch (plain XLA, ``aim_tpu/ops``) where the reference
    runs one scalar tasklet per pair;
  * the reference's WRAM/MRAM variant split survives as the short-read
    ('vmem') and long-read ('hbm') tiers with the reference's semantics;
  * multi-device / multi-host scaling is contiguous pair sharding over a
    ``jax.sharding.Mesh`` (the reference's 2500-DPU data parallelism,
    host.c:191) with ordered result gathering by pair idx;
  * the host runtime around the device compute path (pair-file parsing,
    CIGAR traceback walking, run-length output emission) is native C++
    (``aim_tpu/native``), mirroring the reference's C host tier.
"""

__version__ = "0.1.0"

from aim_tpu.config import AlignConfig, derive_config  # noqa: F401
