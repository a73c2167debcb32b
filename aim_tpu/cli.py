"""aim-tpu command-line launcher.

One CLI reproducing the reference's six per-variant launcher scripts
(ref: */*/run-*-pim-*.py) as subcommands:

    python -m aim_tpu.cli wfa -i pairs.txt -o out -l 100 -e 0.01 -n 40000 -b -r
    python -m aim_tpu.cli nw  -i pairs.txt -o out -l 100 -e 0.01 -n 40000 -b
    python -m aim_tpu.cli swg -i pairs.txt -o out -l 100 -e 0.01 -n 40000 -b

Flags follow the reference exactly: -i -o -l -e -n -m -x -g -a -b -r -t -d
(ref: run-wfa-pim-mram.py:6-33).  MAX_SCORE / READ_SIZE are derived with
the launchers' formulas (see config.derive_config); what the reference
pushes through `make FLAGS=-D…` becomes a re-jit here.  -t/-d (tasklets /
DPUs) map to the per-device batch and the device count: -t shrinks the
batch, -d caps the number of devices the run is sharded over (default:
every visible device).
"""

from __future__ import annotations

import argparse
import sys

from aim_tpu.config import derive_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="aim-tpu", add_help=True)
    sub = ap.add_subparsers(dest="algo", required=True)

    def common(p, affine):
        p.add_argument("-i", "--input", type=str, required=True,
                       help="Input read pairs file path")
        p.add_argument("-o", "--output", type=str, default="./out",
                       help="Output alignment file path")
        p.add_argument("-l", "--read_length", type=int, required=True,
                       help="Read length")
        p.add_argument("-e", "--error", type=float, required=True,
                       help="Percentage error per read length")
        p.add_argument("-n", "--number_reads", type=int, required=True,
                       help="Number of read pairs to be aligned")
        if affine is not None:
            p.add_argument("-m", "--match_cost", type=int, default=0,
                           help="Cost of characters match")
            p.add_argument("-x", "--mismatch_cost", type=int, default=3,
                           help="Cost of characters mismatch")
        if affine:
            p.add_argument("-g", "--gap_opening", type=int, default=4,
                           help="Cost of opening a new gap")
            p.add_argument("-a", "--gap_extending", type=int, default=1,
                           help="Cost of extending gap")
        elif affine is not None:
            p.add_argument("-g", "--gap", type=int, default=4,
                           help="Cost of gap (GAP_I = GAP_D)")
        p.add_argument("-b", "--backtrace", action="store_true",
                       help="Enable backtracing")
        p.add_argument("-t", "--nr_of_tasklets", type=int, default=None,
                       help="force the per-device batch down to t x 1024 "
                            "pairs (the reference maps -t to NR_TASKLETS, "
                            "honored only when 1 <= t <= the heuristic "
                            "choice; ref: run-wfa-pim-mram.py:108-112)")
        p.add_argument("-d", "--nr_of_dpus", type=int, default=None,
                       help="reference compat; caps the device count")
        p.add_argument("--variant", choices=["vmem", "hbm"], default="vmem",
                       help="memory tier: vmem=short-read (DPU-WRAM "
                            "analogue), hbm=long-read (DPU-MRAM analogue)")
        p.add_argument("--batch-pairs", type=int, default=None,
                       help="pairs per device batch")
        p.add_argument("--energy", action="store_true",
                       help="print an estimated kernel-phase energy (J); "
                            "the reference's -DENERGY probe analogue "
                            "(device-seconds x the cards' power limits)")
        p.add_argument("--device-log", type=str, default="",
                       help="per-device run log path (the reference's "
                            "dpu-out file; disabled when empty)")
        p.add_argument("--profile", type=str, default="",
                       help="write a jax.profiler trace of the device "
                            "phases to this directory (TensorBoard-"
                            "loadable; SURVEY §5.1 probe analogue)")
        p.add_argument("-q", "--quiet", action="store_true")

    nw = sub.add_parser("nw", help="Needleman-Wunsch edit distance")
    common(nw, affine=False)
    ga = sub.add_parser("genasm",
                        help="GenASM bitvector bounded edit distance "
                             "(beyond the reference snapshot: its genasm "
                             "submodule is empty)")
    common(ga, affine=None)
    swg = sub.add_parser("swg", help="Smith-Waterman-Gotoh affine gap")
    common(swg, affine=True)
    wfa = sub.add_parser("wfa", help="wavefront alignment")
    common(wfa, affine=True)
    wfa.add_argument("-r", "--reduced", action="store_true",
                     help="Enable WFA-Adaptive")
    wfa.add_argument("--overflow-backtrace", action="store_true",
                     help="WRAM-variant compat: emit a defined best-effort "
                          "CIGAR for score > MAX_SCORE pairs instead of the "
                          "MRAM-variant skip (the reference WRAM tier "
                          "backtraces on overflow via an out-of-bounds "
                          "read — UB; ref: WFA/DPU-WRAM/dpu/wfa.c:369-376)")
    gen = sub.add_parser(
        "gen", help="generate a synthetic pair file (the WFA repository's "
                    "generate_dataset semantics the reference points at; "
                    "ref: Datasets/README.md:18-26)")
    gen.add_argument("-o", "--output", type=str, required=True,
                     help="Output pair file path")
    gen.add_argument("-n", "--number_reads", type=int, required=True,
                     help="Number of read pairs to generate")
    gen.add_argument("-l", "--read_length", type=int, required=True,
                     help="Pattern length")
    gen.add_argument("-e", "--error", type=float, required=True,
                     help="Edit-error rate (ceil(l*e) edits per pair)")
    gen.add_argument("--seed", type=int, default=0)
    return ap


def config_from_args(args) -> "AlignConfig":
    if args.algo == "genasm":
        # unit costs by definition; MAX_SCORE derives from the NW formula
        cfg = derive_config("genasm", args.read_length, args.error,
                            backtrace=args.backtrace, variant=args.variant)
    # Penalty validation mirrors the launchers (run-wfa-pim-mram.py:44-46).
    elif args.algo in ("swg", "wfa"):
        if (args.match_cost > 0 or args.mismatch_cost <= 0
                or args.gap_opening <= 0 or args.gap_extending <= 0):
            print("Wrong affine gap penalties must be  m <= 0 and g, a, x > 0\n")
            raise SystemExit(-1)
        cfg = derive_config(
            args.algo, args.read_length, args.error,
            match=args.match_cost, mismatch=args.mismatch_cost,
            gap_opening=args.gap_opening, gap_extending=args.gap_extending,
            backtrace=args.backtrace,
            adaptive=getattr(args, "reduced", False),
            variant=args.variant)
    else:
        if args.match_cost > 0 or args.mismatch_cost <= 0 or args.gap <= 0:
            print("Wrong penalties must be  m <= 0 and g, x > 0\n")
            raise SystemExit(-1)
        cfg = derive_config(
            "nw", args.read_length, args.error,
            match=args.match_cost, mismatch=args.mismatch_cost,
            gap=args.gap, backtrace=args.backtrace,
            variant=args.variant)
    if args.batch_pairs:
        cfg = cfg.replace(batch_pairs=args.batch_pairs)
    if getattr(args, "overflow_backtrace", False):
        cfg = cfg.replace(overflow_backtrace=True)
    # -t override: the reference honors it only when it forces the
    # heuristic DOWN (1 <= t <= chosen NR_TASKLETS, run-wfa-pim-mram.py:
    # 106-112).  The analogue knob here is the per-device pair batch, in
    # 1024-pair units (default 65536 = "64 tasklets").
    t = getattr(args, "nr_of_tasklets", None)
    if t is not None and 1 <= t <= cfg.batch_pairs // 1024:
        cfg = cfg.replace(batch_pairs=t * 1024)
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.algo == "gen":
        if args.read_length <= 0 or args.number_reads <= 0:
            print("Undefined read length / number of reads")
            return -1
        from aim_tpu.datagen import write_pair_file
        n = write_pair_file(args.output, args.number_reads,
                            args.read_length, args.error, seed=args.seed)
        print(f"wrote {n} pairs (l={args.read_length}, e={args.error}) "
              f"to {args.output}")
        return 0
    if args.read_length <= 0:
        print("Undefined input read length")
        return -1
    if args.number_reads <= 0:
        print("Undefined number of input reads")
        return -1
    cfg = config_from_args(args)
    from aim_tpu.config import wram_feasible
    if cfg.variant == "vmem" and not wram_feasible(cfg):
        # Parity with the reference WRAM launchers' feasibility exit
        # (ref: run-swg-pim-wram.py "Data doesn't fit in the WRAM").
        print("Data doesn't fit in the WRAM (short-read tier); "
              "use --variant hbm for long reads")
        return -1
    if not args.quiet:
        print(f"algo={cfg.algo} MAX_SCORE={cfg.max_score} "
              f"READ_SIZE={cfg.read_size} backtrace={cfg.backtrace} "
              f"adaptive={cfg.adaptive} variant={cfg.variant}")
    import jax
    from aim_tpu.api import align_file
    sharding = None
    ndev = len(jax.devices())
    if args.nr_of_dpus:
        ndev = min(ndev, args.nr_of_dpus)
    if args.number_reads <= ndev:
        # ref: host.c:180-184 rejects total_nb_reads <= NR_DPUS
        print("Allocated DPUs more than needed")
        return 1
    if ndev > 1:
        from aim_tpu.parallel import make_mesh, pair_sharding
        sharding = pair_sharding(make_mesh(ndev))
        if not args.quiet:
            print(f"Allocated {ndev} device(s)")  # ref: host.c:189
            per = ((args.number_reads // ndev) + 7) // 8 * 8
            print(f"NumReads per device = {per}")  # ref: host.c:192
    align_file(args.input, args.output, args.number_reads, cfg,
               device_sharding=sharding, verbose=not args.quiet,
               device_log=args.device_log or None, energy=args.energy,
               profile_dir=args.profile or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
