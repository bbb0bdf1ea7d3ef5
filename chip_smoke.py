#!/usr/bin/env python3
"""Smoke run of the weighted-LD scan on one NVIDIA GPU.

    python3 chip_smoke.py               # phases 1-5 on one card
    python3 chip_smoke.py --four-cards  # the phase-2 scan on a 4-card mesh
                                        # vs a 1-card mesh, byte-compared

One process holds the card throughout; every phase runs through the
entry points a user calls (``weightedld.cli.main`` in-process, and
``LdSession``), on inputs generated from a fixed seed in a temporary
directory:

1. device check — fails unless JAX's first device is a GPU;
2. phased-cohort VCF (2,504 samples = 5,008 haplotypes x 16,384 biallelic
   sites with seeded LD blocks, gzipped) through ``--stream-ingest
   --r2-threshold 0.2 --pair-output``;
3. gapped pathogen alignment (5,000 sequences x 29,903 columns, default
   CLI flags): masking, Henikoff weights, the hybrid factorized/general
   split;
4. the floor shape N=1,000 x S=49,152 (criterion distribution) through
   ``LdSession`` summarize and stream at r2 > 0.1 — pairs/s printed as
   information;
5. the card-only tests (``pytest -m gpu``, in this process): the
   engine's forms at real width vs the f32 reference tile path, and no f32
   matrix product in the compiled programs.

Phases 2-4 compare against the float64 reference engine
(``weightedld.core.reference_impl``): identical skip/keep decisions (except
within 1e-6 of the 0.95 skip boundary or the r2 threshold), D/D'/r2 within
5e-5, >= 99.9% of printed 4-dp strings equal, every mismatch a one-quantum
flip at a rounding boundary.  Any failure exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 20260
# Shapes (samples, sites) / (sequences, columns, variable columns) /
# (sequences, sites); a CPU rehearsal may shrink them.
VCF_SHAPE = (2504, 16384)
FASTA_SHAPE = (5000, 29903, 2600)
FLOOR_SHAPE = (1000, 49152)
DENSE_MAX_SITES = 2048   # the CLI's auto engine runs dense up to this S
VAL_TOL = 5e-5           # half the 4-dp output quantum
BOUNDARY_TOL = 1e-6      # reference values this close to a decision edge
N_SAMPLE = 2000


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# Comparison against the float64 reference engine
# ---------------------------------------------------------------------------


def read_tsv(path: Path) -> dict:
    """``{(posa, posb): (d_str, dp_str, r2_str)}`` of a pair TSV."""
    out = {}
    with open(path) as fh:
        header = fh.readline()
        assert header.startswith("posa"), header
        for line in fh:
            a, b, d, dp, r2 = line.rstrip("\n").split("\t")
            out[(int(a), int(b))] = (d, dp, r2)
    return out


class Comparison:
    """Accumulates engine-vs-reference statistics for one phase."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs = {"d": 0.0, "d_prime": 0.0, "r2": 0.0}
        self.n_values = 0
        self.n_str = 0
        self.n_str_equal = 0
        self.n_decisions = 0
        self.n_edge_excused = 0   # decisions differing at a decision edge
        self.max_flip_dist = 0.0

    def values(self, got, ref) -> None:
        """``got``: the engine's raw f32 (d, dp, r2); ``ref``: the
        reference's float64 values."""
        import numpy as np

        for key, g, r in zip(("d", "d_prime", "r2"), got, ref):
            if not (np.isfinite(g) and np.isfinite(r)):
                check(np.isnan(g) == np.isnan(r)
                      and (np.isnan(g) or g == r),
                      f"{self.name}: non-finite {key} mismatch {g} vs {r}")
                continue
            diff = abs(g - r)
            self.max_abs[key] = max(self.max_abs[key], diff)
            check(diff <= VAL_TOL,
                  f"{self.name}: {key} differs by {diff:.3g} "
                  f"(engine {g!r}, reference {r!r})")
        self.n_values += 1

    def strings(self, got_strs, ref) -> None:
        """4-dp strings vs the reference rounded the writer's way.  A
        mismatch must be a one-quantum flip with the reference value
        within VAL_TOL of the rounding boundary between the two strings;
        the largest such distance is reported."""
        for s, r in zip(got_strs, ref):
            want = repr(round(float(r), 4))
            self.n_str += 1
            if s == want:
                self.n_str_equal += 1
                continue
            g, w = float(s), float(want)
            boundary = 0.5 * (g + w)
            dist = abs(r - boundary)
            self.max_flip_dist = max(self.max_flip_dist, dist)
            check(abs(abs(g - w) - 1e-4) <= 1e-9 and dist <= VAL_TOL,
                  f"{self.name}: printed {s} vs reference {r!r} "
                  "(not a one-quantum rounding-boundary flip)")

    def report(self) -> None:
        frac = self.n_str_equal / self.n_str if self.n_str else 1.0
        say(f"[{self.name}] compared {self.n_values} pairs' values, "
            f"{self.n_decisions} keep decisions ({self.n_edge_excused} "
            f"differing at a decision edge); max |engine - reference| "
            f"D {self.max_abs['d']:.3g}, D' {self.max_abs['d_prime']:.3g}, "
            f"r2 {self.max_abs['r2']:.3g}; 4-dp strings equal "
            f"{self.n_str_equal}/{self.n_str} ({100 * frac:.3f}%), "
            f"largest reference distance to a flipped boundary "
            f"{self.max_flip_dist:.3g}")
        check(frac >= 0.999,
              f"{self.name}: only {100 * frac:.3f}% of 4-dp strings equal")


def reference_for(aln, weights, i: int, j: int):
    from weightedld.core.reference_impl import reference_pair

    return reference_pair(aln[:, i], aln[:, j], weights)


def near_threshold(ref, thr) -> bool:
    return thr is not None and ref is not None and \
        abs(ref[2] - thr) <= BOUNDARY_TOL


def near_skip_edge(aln, weights, i, j) -> bool:
    """True when the reference's major-allele weight share lies within
    BOUNDARY_TOL of the 0.95 skip boundary (decisions may differ there)."""
    import numpy as np

    a, b = aln[:, i], aln[:, j]
    good = (a < 5) & (b < 5)
    a, b, w = a[good], b[good], weights[good]
    for col in (a, b):
        uniq, counts = np.unique(col, return_counts=True)
        if len(uniq) < 2:
            return False
    shares = []
    for col, other in ((a, b), (b, a)):
        uniq, counts = np.unique(col, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        maj, dmin = uniq[order[0]], uniq[order[1]]
        ou, oc = np.unique(other, return_counts=True)
        oo = np.argsort(-oc, kind="stable")
        keep = ((col == maj) | (col == dmin)) & \
            ((other == ou[oo[0]]) | (other == ou[oo[1]]))
        tot = w[keep].sum()
        if tot > 0:
            shares.append(w[keep & (col == maj)].sum() / tot)
    return any(abs(s - 0.95) <= BOUNDARY_TOL for s in shares)


def compare_records(cmp: Comparison, printed: dict, raw: dict, aln,
                    weights, site_map, thr, rng) -> None:
    """A seeded sample of emitted records vs the reference: the CLI's 4-dp
    strings (``printed``) and the session API's raw f32 values (``raw``,
    the same engine on the same input)."""
    idx_of = {int(p): k for k, p in enumerate(site_map)}
    keys = list(printed)
    check(len(keys) > 0, f"{cmp.name}: no records emitted")
    pick = rng.choice(len(keys), size=min(N_SAMPLE, len(keys)),
                      replace=False)
    for k in pick:
        pa, pb = keys[k]
        i, j = idx_of[pa], idx_of[pb]
        ref = reference_for(aln, weights, i, j)
        cmp.n_decisions += 1
        if ref is None or (thr is not None and ref[2] <= thr):
            check(near_threshold(ref, thr)
                  or near_skip_edge(aln, weights, i, j),
                  f"{cmp.name}: emitted pair ({pa}, {pb}) is skipped or "
                  f"below threshold in the reference ({ref})")
            cmp.n_edge_excused += 1
            continue
        cmp.strings(printed[(pa, pb)], ref)
        if (pa, pb) in raw:
            cmp.values(raw[(pa, pb)], ref)
        else:
            check(near_threshold(ref, thr),
                  f"{cmp.name}: ({pa}, {pb}) printed but not streamed")


def stream_raw(ses) -> dict:
    """``{(posa, posb): (d, dp, r2)}`` raw f32 records of a session scan."""
    out = {}
    for _, r in ses.stream():
        out.update({(int(a), int(b)): (float(d), float(dp), float(r2))
                    for a, b, d, dp, r2 in zip(r.pos_a, r.pos_b, r.d,
                                               r.d_prime, r.r2)})
    return out


def compare_random_pairs(cmp: Comparison, records: dict, aln, weights,
                         site_map, thr, rng) -> None:
    """Seeded random site pairs: emitted exactly when the reference keeps
    them above the threshold (up to decision-edge ties)."""
    n = len(site_map)
    for _ in range(N_SAMPLE):
        i, j = sorted(rng.choice(n, size=2, replace=False).tolist())
        ref = reference_for(aln, weights, i, j)
        want = ref is not None and (thr is None or ref[2] > thr)
        have = (int(site_map[i]), int(site_map[j])) in records
        cmp.n_decisions += 1
        if want != have:
            check(near_threshold(ref, thr)
                  or near_skip_edge(aln, weights, i, j),
                  f"{cmp.name}: pair ({i}, {j}) emitted={have} but the "
                  f"reference says {ref}")
            cmp.n_edge_excused += 1


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def make_vcf(tmp: Path) -> Path:
    from weightedld.io.synthetic import write_synthetic_vcf

    t0 = time.monotonic()
    path = write_synthetic_vcf(tmp / "cohort.vcf.gz",
                               n_samples=VCF_SHAPE[0],
                               n_sites=VCF_SHAPE[1], seed=SEED)
    say(f"[phase2] wrote {path.name} ({path.stat().st_size / 1e6:.1f} MB) "
        f"in {time.monotonic() - t0:.1f}s")
    return path


def phase_vcf(tmp: Path, vcf: Path) -> None:
    import numpy as np

    from weightedld.cli import main
    from weightedld.core.henikoff import henikoff_weights_host
    from weightedld.io.vcf import read_vcf

    tsv = tmp / "cohort.pairs.tsv"
    t0 = time.monotonic()
    rc = main(["--file", str(vcf), "--stream-ingest", "--r2-threshold",
               "0.2", "--pair-output", str(tsv)])
    check(rc == 0, f"phase2: CLI exited {rc}")
    dt = time.monotonic() - t0
    records = read_tsv(tsv)
    say(f"[phase2] CLI --stream-ingest: {len(records)} records at r2 > 0.2 "
        f"in {dt:.1f}s (ingest, weights, compile and scan)")

    aln, site_map = read_vcf(vcf)
    check(aln.shape == (2 * VCF_SHAPE[0], VCF_SHAPE[1]),
          f"phase2: shape {aln.shape}")
    weights = henikoff_weights_host(aln)
    from weightedld.runtime.driver import DriverConfig, LdSession

    raw = stream_raw(LdSession(aln, weights, site_map,
                               DriverConfig(r2_threshold=0.2)))
    rng = np.random.default_rng(SEED + 2)
    cmp = Comparison("phase2")
    compare_records(cmp, records, raw, aln, weights, site_map, 0.2, rng)
    compare_random_pairs(cmp, records, aln, weights, site_map, 0.2, rng)
    cmp.report()


def phase_fasta(tmp: Path) -> None:
    import numpy as np

    from weightedld.cli import main
    from weightedld.io import native
    from weightedld.io.synthetic import (
        synthetic_alignment_fasta,
        write_fasta_bytes,
    )
    from weightedld.pipeline import WldConfig, prepare

    rng = np.random.default_rng(SEED + 3)
    seqs = synthetic_alignment_fasta(rng, *FASTA_SHAPE)
    fasta = write_fasta_bytes(tmp / "pathogen.fasta", seqs)
    del seqs
    say(f"[phase3] FASTA reader: "
        f"{'native' if native.available() else 'python'}")
    tsv = tmp / "pathogen.pairs.tsv"
    t0 = time.monotonic()
    rc = main(["--file", str(fasta), "--pair-output", str(tsv)])
    check(rc == 0, f"phase3: CLI exited {rc}")
    dt = time.monotonic() - t0
    records = read_tsv(tsv)
    say(f"[phase3] CLI default flags: {len(records)} records in {dt:.1f}s "
        f"(ingest, mask, weights, compile, scan and write)")

    res = prepare(fasta, WldConfig())
    aln = res.alignment
    check(aln.shape[1] > DENSE_MAX_SITES,
          f"phase3: only {aln.shape[1]} LD sites — the CLI would not take "
          "the tiled engine")
    check(bool((aln == 5).any()), "phase3: no ambiguity codes survived")
    from weightedld.runtime.driver import DriverConfig, LdSession

    ses = LdSession(aln, res.weights, res.site_map, DriverConfig())
    say(f"[phase3] {aln.shape[0]} x {aln.shape[1]} LD sites; factorized "
        f"everywhere={ses._majmin}, hybrid="
        f"{ses._hybrid_safe is not None}, packed="
        f"{ses._site_perm is not None}"
        + (f", general-form tile pairs "
           f"{int((~ses._hybrid_safe).sum())}/{len(ses._hybrid_safe)}"
           if ses._hybrid_safe is not None else ""))
    check(ses._hybrid_safe is not None,
          "phase3: the hybrid factorized/general split did not engage")
    raw = stream_raw(ses)
    del ses
    weights = np.asarray(res.weights, dtype=np.float64)
    cmp = Comparison("phase3")
    compare_records(cmp, records, raw, aln, weights, res.site_map, None,
                    rng)
    compare_random_pairs(cmp, records, aln, weights, res.site_map, None, rng)
    cmp.report()


def phase_floor() -> None:
    import jax.numpy as jnp
    import numpy as np

    from weightedld.core.henikoff import henikoff_weights
    from weightedld.io.synthetic import criterion_alignment
    from weightedld.runtime.driver import DriverConfig, LdSession

    (n, s), thr = FLOOR_SHAPE, 0.1
    rng = np.random.default_rng(SEED + 4)
    aln = criterion_alignment(rng, n, s)
    w = np.asarray(henikoff_weights(jnp.asarray(aln)))
    t0 = time.monotonic()
    ses = LdSession(aln, w, np.arange(s), DriverConfig(r2_threshold=thr))
    summ = ses.summarize()
    recs = stream_raw(ses)
    say(f"[phase4] N={n} S={s}: session + first scans "
        f"{time.monotonic() - t0:.1f}s (tile {ses.cfg.tile}, "
        f"{ses.cfg.tiles_per_shard_batch} tiles/batch, {ses.n_batches} "
        f"batches); {summ['n_pairs']} kept pairs, "
        f"{summ['n_over_threshold']} over r2 {thr}")
    check(summ["n_over_threshold"] == len(recs),
          "phase4: stream and summarize disagree on the record count")
    n_pairs = s * (s - 1) // 2
    for what, fn in (("summarize", ses.summarize),
                     ("stream", lambda: [0 for _ in ses.stream()])):
        best = float("inf")
        for _ in range(3):
            t0 = time.monotonic()
            fn()
            best = min(best, time.monotonic() - t0)
        say(f"[phase4] {what}: {n_pairs / best:.4g} pairs/s "
            f"({best:.3f}s per scan of {n_pairs} pairs; information, "
            "not a claim)")
    top = ses.top_pairs(N_SAMPLE)
    weights = np.asarray(w, dtype=np.float64)
    cmp = Comparison("phase4")
    for a, b, d, dp, r2 in zip(top.pos_a, top.pos_b, top.d, top.d_prime,
                               top.r2):
        ref = reference_for(aln, weights, int(a), int(b))
        cmp.n_decisions += 1
        check(ref is not None or near_skip_edge(aln, weights, int(a),
                                                int(b)),
              f"phase4: top pair ({a}, {b}) is skipped by the reference")
        if ref is not None:
            cmp.values((float(d), float(dp), float(r2)), ref)
        else:
            cmp.n_edge_excused += 1
    r2_floor = float(np.min(top.r2))
    top_set = set(zip(top.pos_a.tolist(), top.pos_b.tolist()))
    for _ in range(N_SAMPLE):
        i, j = sorted(rng.choice(s, size=2, replace=False).tolist())
        ref = reference_for(aln, weights, i, j)
        cmp.n_decisions += 1
        if ref is not None and ref[2] > r2_floor + BOUNDARY_TOL:
            check((i, j) in top_set,
                  f"phase4: pair ({i}, {j}) r2 {ref[2]} beats the top-"
                  f"{N_SAMPLE} floor {r2_floor} but is missing")
    for (a, b), got in list(recs.items())[:N_SAMPLE]:
        ref = reference_for(aln, weights, a, b)
        check(ref is not None and (ref[2] > thr
                                   or abs(ref[2] - thr) <= BOUNDARY_TOL),
              f"phase4: record ({a}, {b}) fails the reference {ref}")
        cmp.values(got, ref)
    cmp.report()


class _Outcomes:
    """pytest plugin: counts the tests that passed and those that did not
    (failed, errored or skipped)."""

    def __init__(self):
        self.passed = 0
        self.not_passed = []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed or report.skipped:
            self.not_passed.append(f"{report.nodeid} ({report.outcome})")


def phase_card_tests(repo: Path) -> None:
    """The card-only tests (``-m gpu``) in this process, on this card: the
    engine's forms at real width against the f32 reference path, and the
    compiled programs' freedom from f32 matrix products.  A skip counts as
    a failure here."""
    import pytest

    out = _Outcomes()
    rc = pytest.main([str(repo / "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"],
                     plugins=[out])
    say(f"[phase5] card-only tests: {out.passed} passed, "
        f"{len(out.not_passed)} not passed")
    check(rc == 0 and out.passed > 0 and not out.not_passed,
          f"phase5: pytest -m gpu exited {rc}; not passed: "
          f"{out.not_passed}")


def phase_four_cards(tmp: Path) -> None:
    import jax
    import numpy as np

    from weightedld.cli import main
    from weightedld.parallel.triangle import pairs_per_shard
    from weightedld.runtime.driver import DriverConfig
    from weightedld.runtime.ingest import session_from_vcf
    from jax.sharding import Mesh

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards: {len(devs)} device(s) visible")
    vcf = make_vcf(tmp)
    outs = {}
    for nd in (4, 1):
        tsv = tmp / f"cohort.{nd}.tsv"
        t0 = time.monotonic()
        # --sort: records in (posa, posb) order, so the bytes do not
        # depend on how the plan is striped over the shards.
        rc = main(["--file", str(vcf), "--stream-ingest", "--r2-threshold",
                   "0.2", "--sort", "--pair-output", str(tsv),
                   "--devices", str(nd)])
        check(rc == 0, f"--four-cards: CLI on {nd} card(s) exited {rc}")
        outs[nd] = tsv.read_bytes()
        n_rec = outs[nd].count(b"\n") - 1
        say(f"[four-cards] {nd}-card mesh: {n_rec} records in "
            f"{time.monotonic() - t0:.1f}s")
    check(outs[4] == outs[1], "--four-cards: TSVs differ between the 4-card "
          "and 1-card meshes")
    say("[four-cards] 4-card and 1-card TSVs are byte-identical "
        f"({len(outs[1])} bytes)")
    mesh = Mesh(np.asarray(devs[:4]), ("tiles",))
    ses = session_from_vcf(vcf, cfg=DriverConfig(r2_threshold=0.2),
                           mesh=mesh)
    pps = pairs_per_shard(ses.plan, 4)
    say(f"[four-cards] pairs_per_shard {pps.tolist()} (balance "
        f"{pps.mean() / pps.max():.6f})")
    ses.summarize()
    holders = {sh.device for sh in ses.codes_dev.addressable_shards}
    check(holders == set(devs[:4]),
          f"--four-cards: the codes sit on {sorted(map(str, holders))}")
    for d in devs[:4]:
        st = d.memory_stats()
        say(f"[four-cards] {d}: memory_stats bytes_in_use "
            f"{st and st.get('bytes_in_use')}, peak_bytes_in_use "
            f"{st and st.get('peak_bytes_in_use')}")
        if st:
            check(st["bytes_in_use"] >= ses.codes_dev.nbytes,
                  f"--four-cards: {d} holds less than the codes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the phase-2 scan on a 4-card mesh and a "
                    "1-card mesh and byte-compare the TSVs")
    args = ap.parse_args(argv)

    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        import jax

        import weightedld  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 1
    say(f"[phase1] device {dev.device_kind}, {len(jax.devices())} "
        f"device(s); JAX {jax.__version__}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{jax.config.jax_compilation_cache_dir!r}")
    card = gpu_info()
    say(f"[phase1] nvidia-smi: {card}")

    # The native FASTA/VCF reader is built in the checkout when a compiler
    # is present; otherwise the Python readers run (phase 3 says which).
    try:
        built = subprocess.run(
            ["make", "-C", str(repo / "native"), "libwldio.so"],
            capture_output=True, text=True, timeout=300)
        if built.returncode:
            err = (built.stderr.strip().splitlines() or ["?"])[-1]
            say(f"[phase1] native reader not built (make: {err}); Python "
                "readers run")
    except (OSError, subprocess.SubprocessError) as e:
        say(f"[phase1] native reader not built ({e}); Python readers run")

    t_all = time.monotonic()
    try:
        with tempfile.TemporaryDirectory(prefix="wld_smoke_") as tmpd:
            tmp = Path(tmpd)
            if args.four_cards:
                phase_four_cards(tmp)
            else:
                for name, fn in (("phase2", lambda: phase_vcf(tmp,
                                                              make_vcf(tmp))),
                                 ("phase3", lambda: phase_fasta(tmp)),
                                 ("phase4", phase_floor),
                                 ("phase5", lambda: phase_card_tests(repo))):
                    t0 = time.monotonic()
                    fn()
                    say(f"[{name}] ok in {time.monotonic() - t0:.1f}s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"[done] all phases passed in {time.monotonic() - t_all:.1f}s")
    say(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
