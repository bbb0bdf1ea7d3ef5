"""Command-line interface.

Exposes the union of the reference Python flags (``WeightedLD.py:405-418``:
``--file``, ``--min-acgt``, ``--min-variability``, ``--unweighted``) and the
reference Rust flags (``main.rs:19-68``: ``--max-minor``, ``--r2-threshold``,
``--pair-output``, ``--weights-output``), with Python-semantics defaults
(no r2 threshold, 4-dp stdout TSV), plus tiled-engine controls.

Output ordering: the dense engine (small inputs, default) emits pairs in
(site_a, site_b) row-major order like the Python reference; the streaming
tiled engine emits in tile order like the Rust reference's PairStore
(``lib.rs:523-576``).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="weightedld",
        description="Accelerator-native weighted linkage disequilibrium "
        "(D, D', r2) with Henikoff sequence weighting",
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--file", type=Path, default=None,
                   help="input alignment: .fasta/.fa (or .vcf for multi-sample "
                   "VCF); required unless --load-prepared is given")
    p.add_argument("--min-acgt", type=float, default=0.8,
                   help="minimum fraction of A/C/G/T at a site (strict >) "
                   "for inclusion [default 0.8]")
    p.add_argument("--min-variability", type=float, default=0.02,
                   help="minimum minor-symbol fraction (>=) for LD sites "
                   "[default 0.02]")
    p.add_argument("--unweighted", action="store_true",
                   help="use unit weights instead of Henikoff weights")
    p.add_argument("--max-minor", type=float, default=1.0,
                   help="maximum dominant-minor fraction for LD sites "
                   "(Rust-reference flag; 1.0 disables) [default 1.0]")
    p.add_argument("--r2-threshold", type=float, default=None,
                   help="only emit pairs with r2 strictly above this "
                   "(default: emit all surviving pairs, as the Python "
                   "reference; the Rust reference default is 0.1)")
    p.add_argument("--pair-output", type=Path, default=None,
                   help="pair TSV output path (default: stdout)")
    p.add_argument("--weights-output", type=Path, default=None,
                   help="optional per-sequence weights TSV")
    p.add_argument("--weight-mask", choices=("ld", "hk"), default="ld",
                   help="alignment trim used for weighting: 'ld' matches the "
                   "reference CLI, 'hk' matches its test-suite convention")
    p.add_argument("--compat", choices=("python", "rust"), default="python",
                   help="semantics preset: 'python' reproduces WeightedLD.py "
                   "(default); 'rust' reproduces the reference Rust binary "
                   "(paper-formula weights, dominant-minor site filter, "
                   "r2 > 0.1 output threshold, 3-dp TSV) — explicit flags "
                   "still override")
    p.add_argument("--fasta-reader", choices=("python", "rust"),
                   default=None,  # None = follow --compat (explicit wins)
                   help="FASTA ingest semantics: 'python' = BioPython-style "
                   "(wrapped records concatenated, as WeightedLD.py); "
                   "'rust' = the Rust binary's line-based reader (every "
                   "line its own sequence, terminators kept as Unknown, "
                   "ragged lengths abort) for byte-parity against that "
                   "binary; --compat rust selects it")
    p.add_argument("--weighting", choices=("python", "paper"), default="python",
                   help="Henikoff formula variant: 'python' = reference "
                   "WeightedLD.py semantics (default), 'paper' = the "
                   "Henikoff-1994 per-site-distinct formula (the reference's "
                   "Rust variant)")
    p.add_argument("--engine", choices=("auto", "dense", "tiled", "reference"),
                   default="auto",
                   help="dense: one XLA program (small S); tiled: streaming "
                   "sharded driver (large S); reference: exact-f64 Python "
                   "audit engine (tiny inputs only) [default auto]")
    p.add_argument("--tile", type=int, default=None,
                   help="site-tile side of the tiled engine (default: "
                   "auto)")
    p.add_argument("--seq-chunk", type=int, default=None,
                   help="sequence-axis padding multiple of the tiled "
                   "engine's layout (default: auto; set explicitly to "
                   "resume a checkpoint taken under another auto policy)")
    p.add_argument("--weight-quant",
                   choices=("none", "split_bf16", "int8", "int8x3"),
                   default="none",
                   help="weighted-pass arithmetic of the tiled engine. "
                   "Default none = int8x3, a 3-level int8 cascade whose "
                   "weight error (~6e-8, one f32 ulp) is at the f32 "
                   "weights' own precision, with exact integer "
                   "accumulation. split_bf16 = two bf16 passes with f32 "
                   "accumulation. int8 = the lossy 2-level cascade "
                   "(~1.6e-5 — can move r2 by about the 4-dp rounding "
                   "quantum)")
    p.add_argument("--devices", type=int, default=None,
                   help="use only the first N local devices (default: all)")
    p.add_argument("--tiles-per-batch", type=int, default=None,
                   help="tiles per device per dispatch (tiled engine; "
                   "default: auto — sized from the device's memory)")
    p.add_argument("--checkpoint", action="store_true",
                   help="enable batch-level resume for --pair-output runs "
                   "(tiled engine; a .gz output is written as per-segment "
                   "gzip members so resume stays byte-exact)")
    p.add_argument("--ndigits", type=int, default=4,
                   help="output rounding digits [default 4, as reference]")
    p.add_argument("--out-format", choices=("tsv", "plink"), default="tsv",
                   help="pair-record format: 'tsv' = the reference's "
                   "posa/posb/D/D'/R2 rows; 'plink' = PLINK --r2 dprime "
                   "columns (CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2 DP, "
                   "plus a trailing D) with CHROM/ID taken from the VCF "
                   "(FASTA sites get chromosome 0 and site<idx> ids) — "
                   "drop-in for tooling that parses plink.ld; needs "
                   "--file (a prepared cache stores no CHROM/ID columns)")
    p.add_argument("--stats-only", action="store_true",
                   help="print a JSON summary instead of per-pair records")
    p.add_argument("--matrix-output", type=Path, default=None,
                   help="write full square LD matrices (d, d_prime, r2 as "
                   "[S,S] float32 with NaN off-pairs, keep mask, site_map) "
                   "to this .npz instead of per-pair records; O(S^2) host "
                   "memory, so bounded to S <= 32768")
    p.add_argument("--matrix-dtype", choices=("float32", "float16"),
                   default="float32",
                   help="matrix export precision: float16 halves the "
                   "device->host transport and file size (values within "
                   "2^-11 relative of float32; the API also offers "
                   "bfloat16, which .npz cannot round-trip) "
                   "[default float32]")
    p.add_argument("--save-prepared", type=Path, default=None,
                   help="save encoded alignment/masks/weights to an .npz "
                   "cache after ingest")
    p.add_argument("--load-prepared", type=Path, default=None,
                   help="skip ingest; load a prepared .npz cache (overrides "
                   "--file)")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a jax.profiler device trace to this directory")
    p.add_argument("--chrom", type=str, default=None,
                   help="VCF only: keep records of this chromosome (CHROM "
                   "column) — the reference ignores CHROM, so whole-genome "
                   "VCFs mix chromosomes into one position axis; required "
                   "for per-chromosome --ld-decay/--prune-r2 on such files")
    p.add_argument("--region", type=str, default=None, metavar="CHR[:LO-HI]",
                   help="VCF only: keep records of this samtools-style "
                   "region — a chromosome name, optionally with a 1-based "
                   "inclusive POS window (e.g. chr19:44890000-44890200). "
                   "Bare CHR equals --chrom CHR (the two flags are "
                   "mutually exclusive); composable with --stream-ingest")
    p.add_argument("--cross-regions", type=str, nargs=2, default=None,
                   metavar=("A", "B"),
                   help="VCF only: inter-region (rectangular) LD — compute "
                   "ONLY pairs with one site in region A and one in region "
                   "B (each a samtools-style CHR[:LO-HI]; disjoint, may be "
                   "different chromosomes).  Weights are Henikoff over the "
                   "combined A+B sites; posa comes from A, posb from B.  "
                   "O(|A|*|B|) work instead of the full triangle; forces "
                   "the tiled engine; exclusive with --chrom/--region and "
                   "the window flags")
    p.add_argument("--keep-samples", type=str, default=None, metavar="SPEC",
                   help="restrict the analysis to these sequences/samples "
                   "BEFORE masking and weighting: a comma-separated list "
                   "of FASTA record names or VCF header sample names, or "
                   "@FILE with one name per line (both haplotypes of a "
                   "kept VCF sample are kept); unknown names are an error")
    p.add_argument("--exclude-samples", type=str, default=None,
                   metavar="SPEC",
                   help="drop these sequences/samples (same SPEC form as "
                   "--keep-samples; applied after it)")
    p.add_argument("--site-stats", type=Path, default=None,
                   help="write a per-site diagnostic TSV (coverage, major "
                   "code, minor fraction, hk/ld mask verdicts) over ALL "
                   "input sites and exit — explains why sites were kept or "
                   "dropped ('-' = stdout; VCF rows are informational: no "
                   "mask is applied on that path, as in the reference)")
    p.add_argument("--list-chroms", action="store_true",
                   help="VCF only: print the distinct CHROM values (one per "
                   "line, file order) and exit — the valid --chrom "
                   "arguments for a per-chromosome analysis loop")
    p.add_argument("--max-distance", type=int, default=None,
                   help="windowed LD: only compute pairs at most this many "
                   "kept sites apart (prunes the tile plan to an O(S*W) "
                   "band; forces the tiled engine)")
    p.add_argument("--max-distance-bp", type=int, default=None,
                   help="windowed LD in site_map units — base pairs for "
                   "VCF input (PLINK-style bp window; consistent with "
                   "--ld-decay's distance axis), original column indices "
                   "for FASTA.  Prunes the tile plan like --max-distance "
                   "(composable: intersection) and forces the tiled "
                   "engine; needs non-decreasing positions (use --chrom "
                   "on whole-genome VCFs)")
    p.add_argument("--ld-decay", type=str, default=None, metavar="EDGES",
                   help="print a JSON LD-decay curve (kept-pair count and "
                   "mean r2 per distance bin) instead of pair records; "
                   "EDGES = comma-separated ascending bin edges in site_map "
                   "units (bp for VCF), e.g. 0,1000,10000,100000")
    p.add_argument("--r2-hist", type=str, default=None, metavar="EDGES",
                   help="print a JSON histogram of r2 over surviving pairs "
                   "(the way to pick a threshold); EDGES = comma-separated "
                   "ascending bin edges, e.g. 0,0.05,0.1,0.2,0.5,1.01")
    p.add_argument("--prune-r2", type=float, default=None, metavar="THR",
                   help="LD pruning: print the positions of a subset of "
                   "sites in which no surviving pair has r2 > THR "
                   "(greedy, PLINK --indep-pairwise style; combine with "
                   "--max-distance for windowed pruning)")
    p.add_argument("--prune-rule", choices=("maf", "first"), default="maf",
                   help="which endpoint of a conflicting pair to drop: "
                   "'maf' = the lower-minor-allele-frequency site "
                   "(default), 'first' = always the later site")
    p.add_argument("--top", type=int, default=None, metavar="K",
                   help="emit only the K strongest surviving pairs by r2 "
                   "(descending) — threshold-free; selection runs on device "
                   "in the tiled engine (O(K) host traffic per batch)")
    p.add_argument("--sort", action="store_true",
                   help="sort tiled-engine output by (posa, posb) like the "
                   "Python reference (collects all records in memory; the "
                   "default streams in tile order like the Rust reference)")
    p.add_argument("--stream-ingest", action="store_true",
                   help="two-pass streaming ingest straight into the "
                   "device layout (VCF, or FASTA with the default reader/"
                   "weight-mask) — peak host memory is ONE padded matrix "
                   "(chunked gzip inflate; chromosome-scale .vcf.gz / "
                   ".fasta.gz stays RAM-bounded).  Record semantics are "
                   "identical to the default readers; Henikoff weights "
                   "run chunked in f64 (equal to the default's f64 "
                   "weights up to summation order, ~1 ulp).  Forces the "
                   "tiled engine; incompatible with "
                   "--save-prepared and --weighting paper")
    p.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                   help="distributed runtime coordinator address for manual "
                   "multi-process bring-up (Slurm / Open MPI are "
                   "auto-detected without any flags; every process runs the "
                   "SAME command line and only process 0 writes output)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for manual distributed bring-up "
                   "(with --coordinator/--process-id)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for manual distributed bring-up "
                   "(with --coordinator/--num-processes)")
    p.add_argument("--progress", action="store_true",
                   help="log pairs/s progress to stderr")
    p.add_argument("--progress-bar", action="store_true",
                   help="live stderr progress bar with percent/rate/ETA "
                   "(the Rust binary's indicatif analog; in-place on a "
                   "TTY, one line per update otherwise; overrides "
                   "--progress)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _prune_site_id(annot, pos: int) -> str:
    """SNP id for a PRUNE output line: a pruned site can come from either
    endpoint block under --cross-regions, so consult both identity maps;
    a POS carried by both blocks with different ids (different
    chromosomes) is genuinely ambiguous -> '.'."""
    a = annot.id_of.get(pos)
    b = (annot.id_of_b or {}).get(pos)
    if a is not None and b is not None and a != b:
        return "."
    return a if a is not None else (b if b is not None else ".")


def _chrom_range(args):
    """``(chrom, pos_range)`` from --chrom/--region (mutual exclusivity is
    validated up front in main) — ONE definition so the ingest filter and
    the plink identity maps can never use different record sets."""
    if args.region is not None:
        from .io.vcf import parse_region

        return parse_region(args.region)
    return args.chrom, None


def _parse_sample_spec(spec: str | None) -> tuple[str, ...] | None:
    """``--keep-samples``/``--exclude-samples`` SPEC -> name tuple:
    ``@FILE`` reads one name per line (blank lines and ``#`` comments
    skipped — the plink keep-file convention), anything else is a
    comma-separated list."""
    if spec is None:
        return None
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as fh:
            names = [ln.strip() for ln in fh]
        names = [n for n in names if n and not n.startswith("#")]
    else:
        names = [n.strip() for n in spec.split(",") if n.strip()]
    if not names:
        raise ValueError(f"empty sample list: {spec!r}")
    return tuple(names)


def _build_session(args, res, mesh, r2_threshold=None, cross_split=None):
    """The one place a CLI mode turns args into a device session (four
    output modes share it; a new DriverConfig field is threaded once)."""
    from .runtime.driver import DriverConfig, LdSession

    return LdSession(
        res.alignment, res.weights, res.site_map,
        DriverConfig(
            tile=args.tile,
            tiles_per_shard_batch=args.tiles_per_batch,
            r2_threshold=r2_threshold,
            seq_chunk=args.seq_chunk,
            max_site_distance=args.max_distance,
            max_bp_distance=args.max_distance_bp,
            weight_quant=args.weight_quant,
            cross_split=cross_split,
        ),
        mesh=mesh,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        format="[%(levelname)s] %(asctime)s %(message)s",
        level=logging.INFO if args.verbose else logging.ERROR,
        datefmt="%Y-%m-%d %H:%M:%S",
        stream=sys.stderr,
    )
    log = logging.getLogger("weightedld")

    # Distributed bring-up FIRST (before anything touches the jax backend):
    # a pod/Slurm/MPI launcher runs this same command line once per host —
    # every process drives its local chips, only process 0 prints/writes
    # (the reference is a CLI too, main.rs:121-213; no custom script).
    from .parallel.multihost import initialize_distributed, is_output_process

    try:
        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    except (RuntimeError, ValueError) as e:
        print(f"error: distributed bring-up failed: {e}", file=sys.stderr)
        return 2
    emit = is_output_process()

    from .io.writer import open_text_output, write_pairs, write_weights
    from .pipeline import WldConfig, prepare
    from .runtime.profiling import StageTimer

    timer = StageTimer()

    # (--checkpoint composes with a .gz --pair-output: run_to_tsv writes
    # per-segment gzip members so resume can truncate at a member
    # boundary — see GzipMemberWriter.)
    # One output mode per invocation.
    modes = [name for name, on in (
        ("--matrix-output", args.matrix_output is not None),
        ("--stats-only", args.stats_only),
        ("--ld-decay", args.ld_decay is not None),
        ("--r2-hist", args.r2_hist is not None),
        ("--top", args.top is not None),
        ("--prune-r2", args.prune_r2 is not None),
        ("--site-stats", args.site_stats is not None),
        ("--list-chroms", args.list_chroms),
    ) if on]
    if len(modes) > 1:
        print(f"error: {' and '.join(modes)} are mutually exclusive "
              "output modes", file=sys.stderr)
        return 2
    if args.out_format == "plink":
        # --top emits pair records (plink applies); --prune-r2 emits a
        # site list, which plink mode turns into SNP ids (the plink
        # --extract file format); every other query mode emits JSON/TSV
        # of its own shape.
        non_pair = [m for m in modes if m not in ("--top", "--prune-r2")]
        if non_pair:
            print(f"error: --out-format plink only applies to pair-record "
                  f"output, not {non_pair[0]}", file=sys.stderr)
            return 2
        if args.load_prepared is not None:
            print("error: --out-format plink needs --file (a prepared "
                  "cache stores no CHROM/ID columns)", file=sys.stderr)
            return 2
    if (args.list_chroms or args.site_stats is not None) \
            and args.save_prepared is not None:
        print("error: --save-prepared has no effect with a pre-analysis "
              "query mode (--list-chroms/--site-stats); run them "
              "separately", file=sys.stderr)
        return 2
    if args.matrix_output is not None and args.r2_threshold is not None:
        print("warning: --matrix-output writes complete matrices; "
              "--r2-threshold is ignored in this mode", file=sys.stderr)
    if args.checkpoint and str(args.pair_output) == "-":
        print("error: --checkpoint needs a real --pair-output file "
              "(resume truncates to a recorded byte offset; stdout has "
              "none)", file=sys.stderr)
        return 2

    if args.compat == "rust":
        # Reference Rust binary semantics (main.rs:19-68 defaults); explicit
        # flags still win where the user set them.
        if args.weighting == "python":
            args.weighting = "paper"
        if args.r2_threshold is None:
            args.r2_threshold = 0.1
        if args.ndigits == 4:
            args.ndigits = 3
        if args.max_minor == 1.0:
            args.max_minor = 0.5
    if args.fasta_reader is None:
        args.fasta_reader = "rust" if args.compat == "rust" else "python"

    if args.chrom is not None and args.region is not None:
        print("error: --chrom and --region are mutually exclusive (a "
              "region names its chromosome)", file=sys.stderr)
        return 2
    for flag, val in (("--chrom", args.chrom), ("--region", args.region),
                      ("--cross-regions", args.cross_regions)):
        if val is not None and args.file is not None \
                and not str(args.file).endswith((".vcf", ".vcf.gz")):
            print(f"error: {flag} only applies to VCF input (FASTA has no "
                  "chromosome column)", file=sys.stderr)
            return 2
    if args.cross_regions is not None:
        conflicts = [f for f, on in (
            ("--chrom", args.chrom is not None),
            ("--region", args.region is not None),
            ("--max-distance", args.max_distance is not None),
            ("--max-distance-bp", args.max_distance_bp is not None),
            ("--stream-ingest", args.stream_ingest),
            ("--save-prepared", args.save_prepared is not None),
            ("--load-prepared", args.load_prepared is not None),
            ("--site-stats", args.site_stats is not None),
            ("--list-chroms", args.list_chroms),
        ) if on]
        if conflicts:
            print(f"error: --cross-regions is exclusive with "
                  f"{conflicts[0]}", file=sys.stderr)
            return 2
        if args.engine in ("dense", "reference"):
            print("error: --cross-regions needs the tiled engine "
                  f"(--engine {args.engine} computes the full triangle)",
                  file=sys.stderr)
            return 2
        if args.file is None:
            print("error: --cross-regions needs --file", file=sys.stderr)
            return 2
        if args.ld_decay is not None:
            from .io.vcf import parse_region as _pr

            if _pr(args.cross_regions[0])[0] != _pr(args.cross_regions[1])[0]:
                print("error: --ld-decay with --cross-regions needs both "
                      "regions on ONE chromosome (POS distance between "
                      "chromosomes is meaningless)", file=sys.stderr)
                return 2
    try:
        keep_samples = _parse_sample_spec(args.keep_samples)
        exclude_samples = _parse_sample_spec(args.exclude_samples)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.list_chroms:
        # Pre-analysis query: answer and exit before any ingest/compile.
        if args.file is None \
                or not str(args.file).endswith((".vcf", ".vcf.gz")):
            print("error: --list-chroms needs a VCF --file (FASTA has no "
                  "chromosome column)", file=sys.stderr)
            return 2
        from .io.vcf import VcfError, list_chromosomes

        try:
            for c in list_chromosomes(args.file):
                if emit:
                    print(c)
        except (VcfError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    cfg = WldConfig(
        min_acgt=args.min_acgt,
        min_variability=args.min_variability,
        unweighted=args.unweighted,
        max_minor=args.max_minor,
        r2_threshold=args.r2_threshold,
        weight_mask=args.weight_mask,
        weighting=args.weighting,
        chrom=args.chrom,
        fasta_reader=args.fasta_reader,
        region=args.region,
        keep_samples=keep_samples,
        exclude_samples=exclude_samples,
    )

    if args.site_stats is not None:
        # Pre-analysis report over the ORIGINAL (unmasked) sites: needs the
        # raw input file, not a prepared cache (which stores trimmed sites).
        if args.file is None:
            print("error: --site-stats needs --file (a prepared cache holds "
                  "only the trimmed sites)", file=sys.stderr)
            return 2
        from .io.writer import write_site_stats
        from .pipeline import site_stats as _site_stats

        try:
            stats = _site_stats(args.file, cfg)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not emit:
            return 0
        if str(args.site_stats) == "-":
            write_site_stats(stats, sys.stdout)
        else:
            with open_text_output(args.site_stats) as fh:
                write_site_stats(stats, fh)
        return 0

    cross_split = None
    prep_keys = ("min_acgt", "min_variability", "unweighted", "max_minor",
                 "weight_mask", "weighting", "chrom", "fasta_reader",
                 "region", "keep_samples", "exclude_samples")
    t0 = time.monotonic()
    if args.load_prepared:
        from .runtime.cache import load_prepared

        res, prep = load_prepared(args.load_prepared)
        # Preparation happened at save time: warn if the flags given now
        # disagree with the cached preparation (they are NOT re-applied).
        # Tuples (sample lists) are stored as JSON arrays -> compare as lists.
        wanted = {k: (list(v) if isinstance(v := getattr(cfg, k), tuple)
                      else v) for k in prep_keys}
        # Keys absent from an old cache default to the value the OLD code
        # effectively used, not to the requested value — otherwise e.g.
        # --chrom against a pre-chrom cache silently suppresses the
        # mismatch warning.
        legacy_defaults = {"chrom": None, "fasta_reader": "python",
                           "region": None, "keep_samples": None,
                           "exclude_samples": None}
        stored = {k: prep.get(k, legacy_defaults.get(k, wanted[k]))
                  for k in prep_keys}
        diffs = {k: (stored[k], wanted[k]) for k in prep_keys
                 if stored[k] != wanted[k]}
        if diffs:
            print(
                "warning: --load-prepared ignores preparation flags; cached "
                f"vs requested: {diffs}", file=sys.stderr,
            )
    elif args.file is not None and args.stream_ingest:
        # Bounded-memory two-pass ingest straight into the device layout
        # (VCF, or FASTA with the default reader/weight-mask — round 5).
        is_vcf_in = str(args.file).endswith((".vcf", ".vcf.gz"))
        if not is_vcf_in:
            if args.fasta_reader != "python":
                print("error: --stream-ingest streams the default (python/"
                      "BioPython) FASTA framing only; drop --fasta-reader "
                      "rust / --compat rust", file=sys.stderr)
                return 2
            if args.weight_mask != "ld":
                print("error: --stream-ingest weights the LD-trimmed "
                      "buffer (the reference CLI convention); "
                      "--weight-mask hk needs the row-major reader",
                      file=sys.stderr)
                return 2
        if args.save_prepared is not None:
            print("error: --save-prepared needs the sequence-major matrix; "
                  "drop --stream-ingest to cache this input",
                  file=sys.stderr)
            return 2
        if args.weighting != "python":
            print("error: --stream-ingest supports the default (python) "
                  "weighting only", file=sys.stderr)
            return 2
        if args.engine in ("dense", "reference"):
            print(f"error: --stream-ingest requires the tiled engine "
                  f"(--engine {args.engine} holds the matrix in sequence-"
                  "major form)", file=sys.stderr)
            return 2
        from .pipeline import PipelineResult
        from .runtime.driver import DriverConfig
        from .runtime.ingest import prepare_fasta_streamed, prepare_vcf_streamed

        try:
            # The padding must match the session the records mode builds:
            # same tile/seq_chunk flags (auto resolution is deterministic).
            stream_cfg = DriverConfig(tile=args.tile,
                                      seq_chunk=args.seq_chunk)
            hk_mask = ld_mask = None
            if is_vcf_in:
                chrom, pos_range = _chrom_range(args)
                with timer.stage("ingest"):
                    sm, site_map = prepare_vcf_streamed(
                        args.file, chrom=chrom, cfg=stream_cfg,
                        pos_range=pos_range, keep_samples=keep_samples,
                        exclude_samples=exclude_samples,
                    )
            else:
                with timer.stage("ingest"):
                    sm, site_map, hk_mask, ld_mask = prepare_fasta_streamed(
                        args.file, min_acgt=args.min_acgt,
                        min_variability=args.min_variability,
                        max_minor=args.max_minor, cfg=stream_cfg,
                        keep_samples=keep_samples,
                        exclude_samples=exclude_samples,
                    )
            with timer.stage("weights"):
                if args.unweighted:
                    weights = np.ones(sm.n_seqs, dtype=np.float32)
                else:
                    from .core.henikoff import (
                        henikoff_weights_host_site_major,
                    )

                    weights = henikoff_weights_host_site_major(
                        sm.codes, sm.n_sites, sm.n_seqs
                    )
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        res = PipelineResult(alignment=sm, site_map=site_map,
                             weights=weights, hk_mask=hk_mask,
                             ld_mask=ld_mask)
    elif args.file is not None and args.cross_regions is not None:
        from .pipeline import prepare_vcf_cross

        try:
            res, cross_split = prepare_vcf_cross(
                args.file, cfg, args.cross_regions[0],
                args.cross_regions[1], timer=timer)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    elif args.file is not None:
        try:
            res = prepare(args.file, cfg, timer=timer)
        except (ValueError, OSError) as e:  # VcfError, ragged FASTA,
            print(f"error: {e}", file=sys.stderr)   # missing file, ...
            return 2
    else:
        print("error: --file or --load-prepared is required", file=sys.stderr)
        return 2
    if args.save_prepared and emit:
        from .runtime.cache import save_prepared

        save_prepared(args.save_prepared, res,
                      {k: getattr(cfg, k) for k in prep_keys})
    from .runtime.driver import SiteMajorCodes as _SMC

    if isinstance(res.alignment, _SMC):
        n, s = res.alignment.n_seqs, res.alignment.n_sites
    else:
        n, s = res.alignment.shape
    log.info("prepared %d sequences x %d LD sites in %.2fs", n, s,
             time.monotonic() - t0)

    annot = None
    if args.out_format == "plink":
        from .io.writer import PairAnnot

        if str(args.file).endswith((".vcf", ".vcf.gz")):
            from .io.vcf import VcfError, parse_region, site_annotations

            def _maps(chrom, pos_range, ann=None):
                pos, chroms, ids = ann if ann is not None \
                    else site_annotations(args.file, chrom, pos_range)
                co: dict[int, str] = {}
                io_: dict[int, str] = {}
                warned = False
                for p, c, i in zip(pos.tolist(), chroms, ids):
                    if p in co and co[p] != c:
                        # Cross-CHROMOSOME collision: CHR_A/CHR_B columns
                        # would lie.  Resolvable — run per chromosome.
                        raise VcfError(
                            f"--out-format plink: POS {p} appears on two "
                            f"chromosomes ({co[p]} and {c}) — whole-"
                            "genome VCFs mix chromosomes into one "
                            "position axis; run per chromosome with "
                            "--chrom/--region")
                    if p in co and io_[p] != i:
                        # Same-chromosome ID collision (e.g. a SNP and an
                        # indel at one POS after `bcftools norm -m-`):
                        # records carry POS only, so the id column is
                        # genuinely ambiguous for these sites — keep the
                        # first-seen id, warn once.  CHR/BP stay exact.
                        if not warned:
                            print(f"warning: --out-format plink: multiple "
                                  f"records share POS {p} ({io_[p]}, {i}); "
                                  "SNP id columns use the first-seen id "
                                  "for such sites", file=sys.stderr)
                            warned = True
                        continue
                    co[p] = c
                    io_[p] = i
                return co, io_

            try:
                if args.cross_regions is not None:
                    # Per-endpoint maps: block A feeds posa, block B posb
                    # (the blocks may share POS values across chromosomes).
                    # Both collected in ONE file pass.
                    from .io.vcf import site_annotations_multi

                    ca, ra = parse_region(args.cross_regions[0])
                    cb, rb = parse_region(args.cross_regions[1])
                    ann_a, ann_b = site_annotations_multi(
                        args.file, [(ca, ra), (cb, rb)])
                    chrom_of, id_of = _maps(ca, ra, ann_a)
                    chrom_of_b, id_of_b = _maps(cb, rb, ann_b)
                    annot = PairAnnot(chrom_of, id_of, chrom_of_b, id_of_b)
                else:
                    chrom_of, id_of = _maps(*_chrom_range(args))
            except (VcfError, OSError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        else:
            # FASTA: positions are original column indices.
            sm = [int(p) for p in np.asarray(res.site_map)]
            chrom_of = {p: "0" for p in sm}
            id_of = {p: f"site{p}" for p in sm}
        if annot is None:
            annot = PairAnnot(chrom_of, id_of)

    if args.max_distance_bp is not None:
        # Validate BEFORE any session upload/compile (the session-level
        # check raises after setup work on big inputs).
        sm = np.asarray(res.site_map)
        if (np.diff(sm) < 0).any() or (
                sm.size and (sm.min() < 0
                             or sm.max() > np.iinfo(np.int32).max)):
            print("error: --max-distance-bp needs non-decreasing site "
                  "positions that fit int32 (multi-chromosome input? "
                  "run per chromosome with --chrom)", file=sys.stderr)
            return 2

    if args.weights_output and emit:
        with open_text_output(args.weights_output) as fh:
            write_weights(res.weights, fh)

    if s < 2:
        log.info("fewer than 2 sites of interest; nothing to do")
        if not emit:
            return 0
        if args.matrix_output is not None:
            np.savez_compressed(
                args.matrix_output,
                site_map=res.site_map,
                keep=np.zeros((s, s), dtype=bool),
                **{k: np.full((s, s), np.nan, dtype=np.float32)
                   for k in ("d", "d_prime", "r2")},
            )
            return 0
        # Each output mode keeps its own (empty) format.
        if args.stats_only:
            import json

            print(json.dumps({
                "n_sequences": n, "n_sites": s, "n_pairs": 0,
                "n_over_threshold": 0, "r2_sum_over_threshold": 0.0,
                "r2_max": None,
            }))
            return 0
        if args.ld_decay is not None:
            import json

            from .runtime.driver import validate_decay_edges

            try:
                edges = validate_decay_edges(args.ld_decay.split(","))
            except ValueError as e:
                print(f"error: --ld-decay: {e}", file=sys.stderr)
                return 2
            nb = len(edges) - 1
            print(json.dumps({"edges": list(edges), "n_pairs": [0] * nb,
                              "r2_sum": [0.0] * nb, "r2_mean": [None] * nb,
                              "abs_d_prime_sum": [0.0] * nb,
                              "abs_d_prime_mean": [None] * nb,
                              "n_d_prime_finite": [0] * nb}))
            return 0
        if args.r2_hist is not None:
            import json

            from .runtime.driver import validate_hist_edges

            try:
                edges = validate_hist_edges(args.r2_hist.split(","))
            except ValueError as e:
                print(f"error: --r2-hist: {e}", file=sys.stderr)
                return 2
            print(json.dumps({"edges": list(edges),
                              "n_pairs": [0] * (len(edges) - 1)}))
            return 0
        from .io.writer import pair_header

        body = pair_header(annot) + "\n"
        if args.prune_r2 is not None:
            # A lone site is trivially conflict-free: emit its position
            # (SNP id in plink mode).
            if annot is not None:
                body = "".join(f"{_prune_site_id(annot, int(p))}\n"
                               for p in res.site_map)
            else:
                body = "".join(f"{int(p)}\n" for p in res.site_map)
        if args.pair_output:
            with open_text_output(args.pair_output) as fh:
                fh.write(body)
        else:
            sys.stdout.write(body)
        return 0

    engine = args.engine
    if engine == "auto":
        engine = "dense" if s <= 2048 else "tiled"
    if args.max_distance is not None or args.max_distance_bp is not None:
        engine = "tiled"
    if args.cross_regions is not None:
        engine = "tiled"  # the rectangle mask lives in the tiled runners
    if isinstance(res.alignment, _SMC):
        engine = "tiled"  # streamed buffers are laid out for this engine
    if args.weight_quant != "none" and engine != "tiled" \
            and args.matrix_output is None:
        print(f"warning: --weight-quant only applies to the tiled "
              f"engine; the '{engine}' engine runs the exact path "
              "(add --engine tiled to use it)", file=sys.stderr)

    on_progress = None
    if not emit:
        pass  # one progress reporter per pod run (the output process)
    elif args.progress_bar:
        from .io.progressbar import ProgressBar

        on_progress = ProgressBar(sys.stderr)
    elif args.progress:
        def on_progress(p):
            print(
                f"[progress] {p.pairs_done}/{p.pairs_total} pairs evaluated "
                f"({p.pairs_per_s:,.0f} pairs/s, {p.records_emitted} records)",
                file=sys.stderr,
            )

    mesh = None
    if args.devices is not None:
        import jax
        from jax.sharding import Mesh

        mesh = Mesh(np.asarray(jax.devices()[: args.devices]), ("tiles",))

    if args.matrix_output is not None:
        if s > 32768:
            print(f"error: --matrix-output needs O(S^2) host memory; "
                  f"S={s} > 32768 kept sites — use the record outputs",
                  file=sys.stderr)
            return 2
        with timer.stage("upload"):
            session = _build_session(args, res, mesh,
                                     cross_split=cross_split)
        with timer.stage("scan"):
            mats = session.matrices(dtype=np.dtype(args.matrix_dtype))
        if emit:
            with timer.stage("write"):
                np.savez_compressed(args.matrix_output,
                                    site_map=res.site_map, **mats)
        log.info("wrote %s (%d x %d, %d surviving pairs) in %.2fs",
                 args.matrix_output, s, s, int(mats["keep"].sum()),
                 time.monotonic() - t0)
        return 0

    if args.stats_only:
        import json

        if engine == "dense":
            import jax.numpy as jnp

            from .core.ld_dense import ld_all_pairs_dense

            stats = ld_all_pairs_dense(
                jnp.asarray(res.alignment), jnp.asarray(res.weights)
            )
            # Only the upper triangle counts.
            keep = np.triu(np.asarray(stats.keep), k=1)
            r2 = np.asarray(stats.r2)
            if args.r2_threshold is None:
                over = keep  # no threshold: every surviving pair counts
            else:
                over = keep & (r2 > args.r2_threshold)
            out = {
                "n_sequences": n,
                "n_sites": s,
                "n_pairs": int(keep.sum()),
                "n_over_threshold": int(over.sum()),
                "r2_sum_over_threshold": float(r2[over].sum()),
                "r2_max": float(r2[keep].max()) if keep.any() else None,
            }
        else:
            with timer.stage("upload"):
                session = _build_session(args, res, mesh,
                                         r2_threshold=args.r2_threshold,
                                         cross_split=cross_split)
            with timer.stage("scan"):
                out = session.summarize()
        out["elapsed_s"] = time.monotonic() - t0
        if emit:
            print(json.dumps(out))
        return 0

    from .runtime.profiling import device_trace

    trace_dir = str(args.profile_dir) if args.profile_dir else None

    if args.ld_decay is not None:
        import json

        from .runtime.driver import validate_decay_edges

        if args.r2_threshold is not None:
            print("warning: --ld-decay is threshold-free; --r2-threshold "
                  "is ignored in this mode", file=sys.stderr)
        if args.engine in ("dense", "reference"):
            print(f"warning: --ld-decay always runs the tiled session "
                  f"engine (--engine {args.engine} ignored)",
                  file=sys.stderr)
        try:
            # Validate BEFORE building the session: a bad edge list must
            # not cost the alignment upload + kernel compile.
            edges = validate_decay_edges(args.ld_decay.split(","))
        except ValueError as e:
            print(f"error: --ld-decay: {e}", file=sys.stderr)
            return 2
        with timer.stage("upload"):
            session = _build_session(args, res, mesh,
                                     cross_split=cross_split)
        try:
            with device_trace(trace_dir), timer.stage("scan"):
                out = session.ld_decay(edges)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        out["elapsed_s"] = time.monotonic() - t0
        if emit:
            print(json.dumps(out))
        return 0

    if args.r2_hist is not None:
        import json

        from .runtime.driver import validate_hist_edges

        try:
            # Validate BEFORE building the session (like --ld-decay): a bad
            # edge list must not cost the alignment upload + kernel compile.
            edges = validate_hist_edges(args.r2_hist.split(","))
        except ValueError as e:
            print(f"error: --r2-hist: {e}", file=sys.stderr)
            return 2
        with timer.stage("upload"):
            session = _build_session(args, res, mesh,
                                     cross_split=cross_split)
        with device_trace(trace_dir), timer.stage("scan"):
            out = session.r2_histogram(edges)
        out["elapsed_s"] = time.monotonic() - t0
        if emit:
            print(json.dumps(out))
        return 0

    if args.prune_r2 is not None:
        if not np.isfinite(args.prune_r2):
            print(f"error: --prune-r2 needs a finite threshold, got "
                  f"{args.prune_r2}", file=sys.stderr)
            return 2
        if args.r2_threshold is not None:
            print("warning: --prune-r2 supplies its own threshold; "
                  "--r2-threshold is ignored in this mode", file=sys.stderr)
        if args.engine in ("dense", "reference"):
            print(f"warning: --prune-r2 always runs the tiled session "
                  f"engine (--engine {args.engine} ignored)",
                  file=sys.stderr)
        if len(np.unique(res.site_map)) != s:
            # Validate BEFORE the session upload/compile (the session-level
            # check would raise after minutes of setup on big inputs).
            print("error: --prune-r2 needs unique site positions "
                  "(multi-chromosome input? run per chromosome)",
                  file=sys.stderr)
            return 2
        with timer.stage("upload"):
            session = _build_session(args, res, mesh,
                                     cross_split=cross_split)
        try:
            with device_trace(trace_dir), timer.stage("scan"):
                kept = session.prune(args.prune_r2, rule=args.prune_rule,
                                     on_progress=on_progress)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if emit:
            out = open_text_output(args.pair_output) if args.pair_output \
                else sys.stdout
            try:
                if annot is not None:
                    # plink --extract file format: one SNP id per line.
                    for pos in kept:
                        out.write(f"{_prune_site_id(annot, int(pos))}\n")
                else:
                    for pos in kept:
                        out.write(f"{int(pos)}\n")
            finally:
                if args.pair_output:
                    out.close()
        log.info("kept %d of %d sites (r2 <= %g) in %.2fs", len(kept), s,
                 args.prune_r2, time.monotonic() - t0)
        return 0

    if args.top is not None:
        if args.top <= 0:
            print("error: --top needs a positive K", file=sys.stderr)
            return 2
        if args.r2_threshold is not None:
            print("warning: --top is threshold-free; --r2-threshold is "
                  "ignored in this mode", file=sys.stderr)
        from .core.ld_dense import LdRecords

        if engine in ("dense", "reference"):
            import jax.numpy as jnp

            from .core.ld_dense import extract_records, ld_all_pairs_dense

            with device_trace(trace_dir):
                stats = ld_all_pairs_dense(
                    jnp.asarray(res.alignment), jnp.asarray(res.weights)
                )
            rec = extract_records(stats, res.site_map)
            order = np.argsort(-np.asarray(rec.r2), kind="stable")[: args.top]
            rec = LdRecords(*(np.asarray(f)[order] for f in rec))
        else:
            with timer.stage("upload"):
                session = _build_session(args, res, mesh,
                                     cross_split=cross_split)
            with device_trace(trace_dir), timer.stage("scan"):
                rec = session.top_pairs(args.top)
        if emit:
            out = open_text_output(args.pair_output) if args.pair_output \
                else sys.stdout
            try:
                write_pairs(rec, out, ndigits=args.ndigits, annot=annot)
            finally:
                if args.pair_output:
                    out.close()
        log.info("wrote top-%d pairs in %.2fs", len(rec),
                 time.monotonic() - t0)
        return 0

    if engine == "reference":
        from .core.ld_dense import LdRecords
        from .core.reference_impl import reference_ld

        rows = reference_ld(res.alignment, np.asarray(res.weights, np.float64),
                            res.site_map)
        records = LdRecords(
            pos_a=np.asarray([r[0] for r in rows]),
            pos_b=np.asarray([r[1] for r in rows]),
            d=np.asarray([r[2] for r in rows]),
            d_prime=np.asarray([r[3] for r in rows]),
            r2=np.asarray([r[4] for r in rows]),
        )
        if args.r2_threshold is not None:
            m = records.r2 > args.r2_threshold
            records = LdRecords(*(np.asarray(f)[m] for f in records))
        if emit:
            out = open_text_output(args.pair_output) if args.pair_output else sys.stdout
            try:
                write_pairs(records, out, ndigits=args.ndigits,
                            annot=annot)
            finally:
                if args.pair_output:
                    out.close()
    elif engine == "dense":
        import jax.numpy as jnp

        from .core.ld_dense import extract_records, ld_all_pairs_dense

        with device_trace(trace_dir), timer.stage("scan"):
            stats = ld_all_pairs_dense(
                jnp.asarray(res.alignment), jnp.asarray(res.weights)
            )
        records = extract_records(stats, res.site_map, args.r2_threshold)
        if emit:
            with timer.stage("write"):
                out = open_text_output(args.pair_output) \
                    if args.pair_output else sys.stdout
                try:
                    write_pairs(records, out, ndigits=args.ndigits,
                                annot=annot)
                finally:
                    if args.pair_output:
                        out.close()
        log.info("wrote %d pairs in %.2fs", len(records), time.monotonic() - t0)
    else:
        from .runtime.driver import (
            DriverConfig,
            collect_ld_records,
            run_to_tsv,
            stream_ld_records,
        )

        dcfg = DriverConfig(
            tile=args.tile,
            tiles_per_shard_batch=args.tiles_per_batch,
            r2_threshold=args.r2_threshold,
            seq_chunk=args.seq_chunk,
            max_site_distance=args.max_distance,
            max_bp_distance=args.max_distance_bp,
            weight_quant=args.weight_quant,
            cross_split=cross_split,
        )
        if args.sort:
            from .core.ld_dense import LdRecords

            with device_trace(trace_dir), timer.stage("scan"):
                rec = collect_ld_records(
                    res.alignment, res.weights, res.site_map, dcfg, mesh=mesh
                )
            if emit:
                with timer.stage("write"):
                    order = np.lexsort((rec.pos_b, rec.pos_a))
                    rec = LdRecords(*(np.asarray(f)[order] for f in rec))
                    out = open_text_output(args.pair_output) \
                        if args.pair_output else sys.stdout
                    try:
                        write_pairs(rec, out, ndigits=args.ndigits,
                                    annot=annot)
                    finally:
                        if args.pair_output:
                            out.close()
            log.info("wrote %d pairs (sorted) in %.2fs", len(rec),
                     time.monotonic() - t0)
        elif args.pair_output:
            # run_to_tsv is multi-process aware: non-output processes
            # drive their shards into the null device.  It times its own
            # upload / scan+write stages into ``timer``.
            with device_trace(trace_dir):
                nrec = run_to_tsv(
                    res.alignment, res.weights, res.site_map, args.pair_output,
                    dcfg, mesh=mesh, checkpoint=args.checkpoint,
                    ndigits=args.ndigits, on_progress=on_progress,
                    timer=timer, annot=annot,
                )
            log.info("wrote %d pairs in %.2fs", nrec, time.monotonic() - t0)
        else:
            if emit:
                from .io.writer import pair_header

                print(pair_header(annot))
            with device_trace(trace_dir), timer.stage("scan+write"):
                for _, rec in stream_ld_records(
                    res.alignment, res.weights, res.site_map, dcfg, mesh=mesh,
                    on_progress=on_progress,
                    decimals=args.ndigits if 0 <= args.ndigits <= 4 else None,
                ):
                    if emit:
                        write_pairs(rec, sys.stdout, ndigits=args.ndigits,
                                    header=False, annot=annot)
    if args.verbose:
        log.info("stage report:\n%s", timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
