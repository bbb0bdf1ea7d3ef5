"""Streaming all-pairs driver: batches of triangle tiles -> compacted records.

This is the large-S execution engine (the analog of the reference's
``all_weighted_ld_pairs`` driver, ``lib.rs:578-684``): it walks the
upper-triangle tile list in shard-major batches, evaluates each batch on the
device mesh, compacts surviving records on-device, and streams them to the
caller — device memory stays bounded by the batch size and host traffic is
O(records).

Extras the reference lacks (SURVEY.md §5): block-batch checkpoint/resume
(a pod job can restart mid-triangle) and periodic pairs/s progress
reporting (the reference logs pairs/s only at the end, ``main.rs:196-205``).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..core.ld_dense import LdRecords
from ..core.ld_tiled import pad_alignment
from ..parallel.sharded import (
    default_mesh,
    gather_compact,
    make_decay_runner,
    make_hist_runner,
    make_sharded_stats_runner,
    make_topk_runner,
    replicate,
)
from ..parallel.triangle import cdiv, plan_tiles, stripe

log = logging.getLogger("weightedld")

_UNSET = object()  # "use the session default" sentinel (None is meaningful)

# Speculative-compaction capacity ceiling (records): above this, the
# O(capacity * T) gather costs more than the count roundtrip it hides.
_SPEC_CAP_MAX = 1 << 22


@dataclass(frozen=True)
class SiteMajorCodes:
    """An alignment already in the engine's padded SITE-MAJOR layout —
    the zero-copy session input of the streaming VCF ingest
    (:func:`weightedld.runtime.ingest.session_from_vcf`).

    ``codes`` is ``[s_pad, n_pad]`` int8, UNKNOWN-padded on both axes,
    with ``codes[s, k] == alignment[k, s]`` for the row-list readers'
    ``alignment`` (``io/vcf.py:read_vcf_site_major``).  ``s_pad``/``n_pad``
    must equal the session's resolved tile / seq-chunk multiples —
    :meth:`LdSession.required_padding` computes them; the constructor
    validates and raises otherwise (a silently larger buffer would make
    the kernel sweep dead all-UNKNOWN sequence chunks and desync the
    padded weights width).
    """

    codes: np.ndarray
    n_seqs: int
    n_sites: int


@dataclass
class DriverConfig:
    tile: int | None = None         # site-tile side (None = auto, see
                                    # resolve_tile)
    tiles_per_shard_batch: int | None = None  # tiles per device per dispatch
                                    # (None = auto: sized from the
                                    # device's memory, see resolve_batch)
    r2_threshold: float | None = None  # None = emit every surviving pair
    progress_every_s: float = 10.0
    engine: str = "auto"            # auto = the site-major integer engine
                                    # (core.tile_engine) | xla = the f32
                                    # sequence-major reference path
                                    # (core.ld_tiled.tile_stats_batch)
    seq_chunk: int | None = None    # sequence-axis padding multiple of the
                                    # site-major layout (None = 128)
    max_site_distance: int | None = None  # windowed LD (kept-site indices)
    max_bp_distance: int | None = None  # windowed LD in site_map units (bp
                                    # for VCF — PLINK-style; original
                                    # column indices for FASTA; consistent
                                    # with ld_decay's distance axis).
                                    # Needs a non-decreasing site_map.
                                    # Composes with max_site_distance
                                    # (intersection).
    cross_split: int | None = None  # rectangular (inter-region) mode: keep
                                    # only pairs (a, b) with layout index
                                    # a < cross_split <= b — LD between two
                                    # site blocks laid out A then B (the
                                    # CLI's --cross-regions).  Disables the
                                    # unsafe-site packing permutation
                                    # (layout order is load-bearing);
                                    # exclusive with the window flags.
    weight_quant: str = "none"      # weighted-pass arithmetic:
                                    # "none" (default) = the int8x3
                                    # 3-level integer cascade — error <=
                                    # one f32 ulp of max|w| | "split_bf16"
                                    # = two bf16 passes (w_hi + w_lo) |
                                    # "int8" = the lossy 2-level cascade
                                    # (~1.6e-5; can move r2 by about the
                                    # 4-dp output rounding quantum).
    kernel: str = "auto"            # "auto" picks the factorized major/
                                    # dmin form (or the hybrid tile-pair
                                    # split) whenever exactness is proven,
                                    # "general" forces the per-pair form
                                    # everywhere (baseline/diagnostic).


def _resolve_engine(engine: str) -> str:
    """``"auto"`` -> the site-major integer engine (``"int8"``); ``"xla"``
    -> the f32 reference tile path."""
    if engine not in ("auto", "xla"):
        raise ValueError(f"engine must be auto|xla, got {engine!r}")
    return "int8" if engine == "auto" else engine


def validate_decay_edges(edges) -> tuple:
    """Validate LD-decay bin edges early (importable by the CLI so a bad
    edge list fails BEFORE the session uploads/compiles anything): integer,
    ascending, >= 2 entries, within int32 (the device distance dtype)."""
    edges = tuple(int(e) for e in edges)
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"edges must be ascending with >= 2 entries, got {edges}")
    lim = np.iinfo(np.int32)
    if edges[0] < lim.min or edges[-1] > lim.max:
        raise ValueError(
            f"edges must fit int32 (device distance dtype), got {edges}")
    return edges


def validate_hist_edges(edges) -> tuple:
    """Validate r2-histogram bin edges early (importable by the CLI so a
    bad edge list fails BEFORE the session uploads/compiles anything —
    the same validate-before-compile contract as
    :func:`validate_decay_edges`): float, ascending, >= 2 entries."""
    edges = tuple(float(e) for e in edges)
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"edges must be ascending with >= 2 entries, got {list(edges)}")
    return edges


# Auto site-tile side, chosen on an H100 (PERF.md): T=512 beat
# T=256 end to end at every smoke shape (the GEMM's operand bytes per pair
# fall as 1/T); the compressed record wire's tile-local coordinates cap it
# at 512.
TILE_AUTO = 512


def resolve_seq_chunk(seq_chunk: int | None) -> int:
    """Sequence-axis padding multiple (``N_pad = ceil(N / chunk) *
    chunk``): the explicit value, else ``DEFAULT_SEQ_CHUNK``."""
    from ..core.majmin import DEFAULT_SEQ_CHUNK

    return DEFAULT_SEQ_CHUNK if seq_chunk is None else seq_chunk


def resolve_tile(tile: int | None) -> int:
    """Auto site-tile side (``TILE_AUTO``); an explicit ``tile`` always
    wins."""
    return TILE_AUTO if tile is None else tile


# Share of the device's allocatable memory the batch working set may use
# (stat tensors up to three batches deep, plus the contraction operands).
_BATCH_MEM_SHARE = 4
# Budget when the device reports no memory limit (host CPU backends).
_HOST_BATCH_BYTES = 1 << 30


def device_memory_bytes(devices) -> int | None:
    """Allocatable bytes of one device (``memory_stats()["bytes_limit"]``),
    or None where the backend reports none."""
    stats = devices[0].memory_stats()
    return int(stats["bytes_limit"]) if stats and "bytes_limit" in stats \
        else None


def tile_pair_bytes(tile: int, n_pad: int, *, engine: str, majmin: bool,
                    n_planes: int, n_levels: int) -> int:
    """Device bytes one tile pair of a batch occupies: the gathered code
    tiles, the stacked contraction operands and their int32/f32 products
    (one batch at a time), plus the [T, T] stat outputs (d, d', r2 f32,
    keep and mask bytes), which the dispatch pipeline keeps up to three
    batches deep."""
    t, n = tile, n_pad
    stats = 3 * 14 * t * t
    if engine == "xla":
        # f32 one-hot planes [N, T, 5] per side and two [T, T, 5, 5] joints.
        return 2 * 5 * 4 * t * n + 2 * 25 * 4 * t * t + stats
    if majmin:
        ops = (2 + 2 * n_levels + 2) * t * n
        prods = n_levels * 4 * t * t * 4
    else:
        p = n_planes
        ops = (2 + p * (n_levels + 1) + p + 2) * t * n
        prods = (n_levels * p * p * 4 + 2 * p * 4 + p * p * 4) * t * t
    return ops + prods + stats


def resolve_batch(n_tiles_per_shard: int, tile: int, per_tile_bytes: int,
                  mem_bytes: int | None, records_uncapped: bool) -> int:
    """Auto tiles per device per dispatch: as many as the memory budget
    allows (``mem_bytes / _BATCH_MEM_SHARE`` of the device, or
    ``_HOST_BATCH_BYTES`` where the device reports no limit), never more
    than the shard's plan.  With no r2 threshold every surviving pair is a
    record, so the per-batch compaction buffers (~40 B/pair with the
    capacity bucketing) are bounded by the same budget.

    The batches of a shard are then evened out: padding tiles still run
    the contraction, so ``n`` tiles in ``nb`` batches take ``ceil(n / nb)``
    tiles each rather than leaving a mostly-padding last batch."""
    budget = (_HOST_BATCH_BYTES if mem_bytes is None
              else mem_bytes // _BATCH_MEM_SHARE)
    k = budget // max(1, per_tile_bytes)
    if records_uncapped:
        k = min(k, budget // (tile * tile * 40))
    n = max(n_tiles_per_shard, 1)
    k = min(max(k, 1), n)
    return int(cdiv(n, cdiv(n, k)))


def _fetch(arr) -> np.ndarray:
    """Host value of a possibly multi-process array.

    Single-process: a plain device->host copy.  Multi-process: shards on
    other hosts are not addressable, so all-gather them (communication =
    the array itself; every call site keeps these small — counts, moments,
    compacted records)."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def _next_bucket(n: int) -> int:
    """Round up to a power of FOUR: bounds the number of distinct compiled
    gather/fetch shapes (expensive in remote-compile environments) at the
    cost of <=4x buffer slack (transfers are sliced to the true count)."""
    b = 1
    while b < n:
        b <<= 2
    return b


@dataclass
class Progress:
    """Work is measured in *evaluated* pairs (tiles swept x T^2), which is
    what throughput means regardless of how many records pass the r2
    threshold; ``records_emitted`` counts the survivors separately."""

    pairs_done: int       # pairs evaluated so far (emitted tiles * T^2)
    pairs_total: int      # pairs the plan will evaluate
    records_emitted: int  # records surviving keep + threshold so far
    elapsed_s: float

    @property
    def pairs_per_s(self) -> float:
        return self.pairs_done / self.elapsed_s if self.elapsed_s > 0 else 0.0


def _windowed_packing_pays(bad: np.ndarray, cfg, sm_arr: np.ndarray,
                           n_sites: int) -> bool:
    """Cost gate for the windowed class-split packing permutation.

    Packing moves the D dirty sites into trailing tiles whose position
    intervals span ~everything, so each dirty tile pairs against ~every
    block (full-width rows at the general-kernel rate) while the clean
    band (~W wide) turns factorized.  With the general kernel ~2.5x the
    factorized cost, the trade pays roughly when the dirty rows' extra
    width stays under the band's: require ``2 * D <= W_eff`` (W_eff = the
    window in sites; for bp windows, the mean site count per window).
    Dense dirt under a narrow window keeps the unpermuted hybrid path."""
    n_dirty = int(bad.sum())
    w_eff = n_sites
    if cfg.max_site_distance is not None:
        w_eff = min(w_eff, int(cfg.max_site_distance))
    if cfg.max_bp_distance is not None:
        if sm_arr.size and bool((np.diff(sm_arr) < 0).any()):
            # bp windows require a non-decreasing input map anyway
            # (_ensure_sm_dev refuses later); don't permute first.
            return False
        spans = (np.searchsorted(sm_arr, sm_arr + int(cfg.max_bp_distance),
                                 side="right")
                 - np.arange(n_sites) - 1)
        w_eff = min(w_eff, int(spans.mean()))
    return 2 * n_dirty <= w_eff


class LdSession:
    """Device-resident all-pairs LD session.

    Uploads the alignment, weights, and the striped triangle tile plan to the
    mesh ONCE at construction; each :meth:`stream` pass then costs only one
    scalar down + one [K] count vector up per batch (plus O(records)).  This
    is the serving-oriented API — build a session, run many scans (different
    thresholds, resumed ranges) against it.
    """

    def __init__(
        self,
        alignment: np.ndarray,
        weights: np.ndarray | None,
        site_map: np.ndarray,
        cfg: DriverConfig | None = None,
        mesh=None,
    ):
        """``weights=None`` computes Python-formula Henikoff weights ON
        DEVICE from the uploaded codes (one alignment upload instead of
        two); the result is exposed as ``session.weights``.

        ``alignment`` is either a ``[N, S]`` sequence-major code matrix or
        a :class:`SiteMajorCodes` buffer already in the engine's padded
        layout (the streaming-ingest path)."""
        from dataclasses import replace as _replace

        from ..core import majmin as mm

        cfg = cfg or DriverConfig()
        self.mesh = mesh or default_mesh()
        n_dev = self.mesh.devices.size
        self.n_dev = n_dev
        sm = alignment if isinstance(alignment, SiteMajorCodes) else None
        if sm is not None:
            self.n_seqs, self.n_sites = sm.n_seqs, sm.n_sites
        else:
            self.n_seqs, self.n_sites = alignment.shape
        engine = _resolve_engine(cfg.engine)
        if sm is not None and engine != "int8":
            raise ValueError(
                "SiteMajorCodes input requires the site-major engine "
                f"(engine='auto'), got engine={cfg.engine!r}")
        planes = None
        majmin = False
        site_counts = None
        if cfg.kernel not in ("auto", "general"):
            raise ValueError(
                f"kernel must be auto|general, got {cfg.kernel!r}")
        if engine == "int8":
            if sm is not None:
                # Scan only the valid region: the buffer's padding is
                # UNKNOWN by contract and must not disable the factorized
                # form (padded SITES are invisible to it either way —
                # distinct == 0 drops their pairs).
                planes, has_unknown = mm.detect_planes_unknown(
                    sm.codes[: self.n_sites, : self.n_seqs])
            else:
                planes, has_unknown = mm.detect_planes_unknown(alignment)
            # No UNKNOWN anywhere (every VCF matrix; clean FASTA): per-pair
            # major/dmin degenerate to per-site properties and the
            # factorized form applies — one (2T x 2T) contraction block
            # per weight level, independent of alphabet size, identical
            # results (tile_stats_majmin).  With UNKNOWNs present it still
            # applies when every site's count margins exceed the worst-
            # case per-pair removals (majmin_safe_with_unknown).
            if cfg.kernel == "general":
                pass  # forced per-pair form: skip factorized selection
            elif not has_unknown:
                majmin = True
            else:
                if sm is not None:
                    from ..core.sites import site_histogram_host_site_major

                    site_counts = site_histogram_host_site_major(
                        sm.codes, self.n_sites, self.n_seqs)
                else:
                    from ..core.sites import site_histogram_host

                    site_counts = site_histogram_host(alignment)
                majmin = mm.majmin_safe_with_unknown(
                    None, site_counts, n_seqs=self.n_seqs)
        # Unsafe-site PACKING: when the global factorized test fails, the
        # poisoning sites (u > 0) are usually few and SCATTERED — in input
        # order they drop one unsafe site into most tiles, so nearly every
        # tile pair of the hybrid partition below falls to the general
        # form.  Sites are freely permutable (records carry site_map
        # positions; stream order is documented as plan order, --sort
        # restores reference order), so pack every UNKNOWN-carrying site
        # into the trailing tiles: clean x clean tile pairs — the bulk of
        # the triangle — become unconditionally factorized-exact, and only
        # O(dirty_tiles x grid) pairs still need the general form.
        # Clean sites are ordered by DESCENDING stability margin so weak-
        # margin sites concentrate in few tiles (scattered, one weak site
        # per tile drags every tile's min-margin down); dirty sites by
        # ascending u for the same reason.
        #
        # WINDOWED plans: genomic order is load-bearing for the band plan
        # and the in-tile distance masks, but both generalize — the plan
        # via per-tile original-position intervals (plan_tiles_permuted)
        # and the masks via |distance| lookups against the replicated
        # original-index / site-map arrays (windows_by_lookup).  The
        # windowed permutation is the ORDER-PRESERVING class split (clean
        # sites in input order, then dirty sites in input order): the
        # clean block keeps contiguous ascending positions, so clean x
        # clean tiles reproduce a band no wider than the unpermuted one
        # and run factorized, while the (few) dirty tiles pair against
        # every block their members genuinely window.  Gated by
        # _windowed_packing_pays.
        self._site_perm = None
        self._sm_orig_nondecr = None
        self._windowed_packed = False
        if cfg.cross_split is not None:
            if not 0 < cfg.cross_split < self.n_sites:
                raise ValueError(
                    f"cross_split must be in 1..{self.n_sites - 1}, got "
                    f"{cfg.cross_split}")
            if (cfg.max_site_distance is not None
                    or cfg.max_bp_distance is not None):
                raise ValueError(
                    "cross_split does not compose with the window flags "
                    "(a rectangle already bounds the pair set; distances "
                    "across a region boundary are ill-defined for "
                    "multi-chromosome layouts)")
        if (not majmin and site_counts is not None and sm is None
                and cfg.cross_split is None):
            windowed = (cfg.max_site_distance is not None
                        or cfg.max_bp_distance is not None)
            marg_s, u_s = mm.majmin_site_margins(site_counts, self.n_seqs)
            bad = u_s > 0
            ok = bool(bad.any()) and not bool(bad.all())
            if ok and windowed:
                ok = _windowed_packing_pays(
                    bad, cfg, np.asarray(site_map), self.n_sites)
            if ok:
                clean = np.flatnonzero(~bad)
                dirty = np.flatnonzero(bad)
                if windowed:
                    perm = np.concatenate([clean, dirty])
                else:
                    perm = np.concatenate([
                        clean[np.argsort(-marg_s[clean], kind="stable")],
                        dirty[np.argsort(u_s[dirty], kind="stable")],
                    ])
                if not np.array_equal(perm, np.arange(self.n_sites)):
                    sm_arr = np.asarray(site_map)
                    self._sm_orig_nondecr = \
                        not bool((np.diff(sm_arr) < 0).any())
                    alignment = alignment[:, perm]
                    site_map = sm_arr[perm]
                    site_counts = site_counts[perm]
                    self._site_perm = perm
                    self._windowed_packed = windowed
        # The resolved tile/batch size are properties of (alignment,
        # device, config), not of the caller's config object: work on a
        # copy so one DriverConfig can be reused across sessions with
        # different inputs.  Read the resolved values from session.cfg.
        tile = resolve_tile(cfg.tile)
        seq_chunk = resolve_seq_chunk(cfg.seq_chunk)
        n_pad = cdiv(self.n_seqs, seq_chunk) * seq_chunk
        if sm is not None:
            want = (cdiv(self.n_sites, tile) * tile, n_pad)
            if tuple(sm.codes.shape) != want:
                raise ValueError(
                    f"SiteMajorCodes buffer shape {tuple(sm.codes.shape)} "
                    f"does not match the session's resolved padding {want} "
                    f"(tile={tile}, seq_chunk={seq_chunk}); size it with "
                    "LdSession.required_padding(n_seqs, n_sites, cfg)")
        cfg = _replace(cfg, tile=tile, seq_chunk=seq_chunk)
        self.cfg = cfg
        self.site_map = np.asarray(site_map)
        self._sm_dev = None
        if cfg.max_bp_distance is not None:
            # Validate the site map BEFORE any plan/upload work and put the
            # padded copy on device for the in-tile bp mask.
            self._ensure_sm_dev("--max-distance-bp")
        if self._windowed_packed:
            from ..parallel.triangle import plan_tiles_permuted

            self.plan = plan_tiles_permuted(
                self.n_sites, cfg.tile, cfg.max_site_distance,
                max_bp_distance=cfg.max_bp_distance,
                orig_idx=self._site_perm, site_map=self.site_map)
        else:
            self.plan = plan_tiles(self.n_sites, cfg.tile,
                                   cfg.max_site_distance,
                                   max_bp_distance=cfg.max_bp_distance,
                                   site_map=self.site_map,
                                   cross_split=cfg.cross_split)
        # Host reference (no copy) for analyses needing per-site stats
        # (prune's minor-allele frequencies); released after the first MAF
        # computation so a chromosome-scale session does not pin the host
        # alignment for its lifetime.  (The SiteMajorCodes buffer IS the
        # upload source, so holding it costs nothing extra.)
        self._alignment = None if sm is not None else alignment
        self._codes_sm = sm
        self._maf_cache = None
        self._spec_cap = 0  # learned speculative-compaction capacity
        self._cap_hist = []  # last 2 per-shard buckets (shrink window)
        self._batch_caps = {}  # batch index -> last-seen per-shard max
        self._caps_thr = _UNSET  # threshold the per-batch memory is for

        # Hybrid tile-pair partition: when UNKNOWNs break the GLOBAL
        # factorized safety test (majmin_safe_with_unknown), most tile
        # PAIRS are usually still exactly factorizable — a pair (a, b)
        # only needs site a's count margins to absorb site b's UNKNOWN
        # count and vice versa, and clean x clean tile pairs are always
        # exact (nothing is ever removed).  Split the plan: safe tile pairs
        # run the factorized form (phase 0), the rest the general per-pair
        # form (phase 1) — identical results, and a real FASTA with a few
        # scattered ambiguity codes keeps ~the factorized rate instead of
        # falling entirely to the general form (majmin_tile_margins has the
        # stability argument).
        self._hybrid_safe = None
        if engine == "int8" and not majmin and site_counts is not None:
            stab, umax = mm.majmin_tile_margins(
                site_counts, self.n_seqs, cfg.tile, self.plan.grid)
            pti, ptj = self.plan.tile_i, self.plan.tile_j
            safe = (
                ((umax[ptj] == 0) | (stab[pti] > umax[ptj]))
                & ((umax[pti] == 0) | (stab[ptj] > umax[pti]))
            )
            if safe.all():
                # Strictly weaker than the global test: e.g. all UNKNOWNs
                # concentrated at one site still pair-safely everywhere.
                majmin = True
            elif safe.any():
                self._hybrid_safe = np.asarray(safe)
        self._majmin = majmin
        hybrid = self._hybrid_safe is not None
        self.engine = engine

        # Codes in the engine's layout, and the weights (on-device Henikoff
        # from the buffer being uploaded anyway when none are given).
        codes_pre = None
        if engine == "int8":
            codes_host = (sm.codes if sm is not None  # zero-copy upload
                          else mm.pad_alignment_site_major(
                              alignment, cfg.tile, cfg.seq_chunk))
            if weights is None:
                from ..core.henikoff import henikoff_weights_site_major

                (codes_pre,) = replicate(self.mesh, codes_host)
                weights = np.asarray(
                    henikoff_weights_site_major(codes_pre, self.n_seqs)
                )[: self.n_seqs]
        else:
            codes_host = pad_alignment(alignment, cfg.tile)
            if weights is None:
                from ..core.henikoff import henikoff_weights

                weights = np.asarray(henikoff_weights(jnp.asarray(alignment)))
        w_arr = np.asarray(weights, dtype=np.float32)
        self.weights = w_arr

        wquant, exact, unit = "", False, False
        if engine == "int8":
            if cfg.weight_quant not in ("none", "split_bf16", "int8",
                                        "int8x3"):
                raise ValueError(
                    f"weight_quant must be none|split_bf16|int8|int8x3, "
                    f"got {cfg.weight_quant!r}")
            exact = mm.weights_bf16_exact(w_arr)
            unit = bool((w_arr == 1.0).all())
            if exact or unit or cfg.weight_quant == "split_bf16":
                wquant = ""
            elif cfg.weight_quant == "none":
                # Default weighted path: the 3-level int8 cascade.  Its
                # weight representation error (<= one f32 ulp of max|w|)
                # is at the f32 weights' own precision and the integer
                # joints accumulate exactly.
                wquant = "int8x3"
            else:
                wquant = cfg.weight_quant
            if wquant:
                weights_host = mm.pad_weights_int8(
                    w_arr, cfg.seq_chunk, levels=3 if wquant == "int8x3"
                    else 2)
            else:
                weights_host = mm.pad_weights(w_arr, cfg.seq_chunk)
        else:
            weights_host = w_arr
        from ..core.tile_engine import n_weight_levels

        nlev = n_weight_levels(exact, unit, wquant)

        # Tiles per device per dispatch, sized from the device's memory.
        mem = device_memory_bytes(self.mesh.local_devices)
        n_per_shard = cdiv(self.plan.n_tiles, n_dev)

        def _k(majmin_phase: bool, n_shard: int) -> int:
            if cfg.tiles_per_shard_batch is not None:
                return cfg.tiles_per_shard_batch
            per = tile_pair_bytes(
                cfg.tile, n_pad, engine=engine, majmin=majmin_phase,
                n_planes=len(planes or mm.ALL_PLANES), n_levels=nlev)
            return resolve_batch(n_shard, cfg.tile, per, mem,
                                 cfg.r2_threshold is None)

        common = dict(
            tile=cfg.tile, n_sites=self.n_sites, engine=engine,
            max_site_distance=cfg.max_site_distance,
            max_bp_distance=cfg.max_bp_distance,
            windows_by_lookup=self._windowed_packed,
            cross_split=cfg.cross_split,
        )
        if engine == "int8":
            common.update(planes=planes, exact_weights=exact,
                          unit_weights=unit, wquant=wquant)
        if hybrid:
            n_unsafe = int((~self._hybrid_safe).sum())
            k = _k(True, cdiv(len(self._hybrid_safe) - n_unsafe, n_dev))
            # The phase-1 batch is sized to the (packed, usually tiny)
            # unsafe phase — power-of-4 bucketed to bound compiled shapes —
            # so its dispatch does not allocate and sweep phase-0-sized
            # [K, T, T] outputs for a handful of real tiles.
            self._k2 = min(_k(False, n_per_shard),
                           _next_bucket(max(1, cdiv(n_unsafe, n_dev))))
        else:
            k = _k(majmin, n_per_shard)
            self._k2 = None
        cfg.tiles_per_shard_batch = k  # our copy; callers read session.cfg
        # (majmin flag, kwargs) per phase, for fused stats+records runner
        # variants built lazily per capacity bucket (_fused_runner).
        self._fused_common = [(majmin or hybrid,
                               {**common, "k_per_batch": k})]
        self.runner = make_sharded_stats_runner(
            self.mesh, majmin=majmin or hybrid, **common, k_per_batch=k)
        self._runner2 = None
        if hybrid:
            # Hybrid phase 1: the general per-pair form for the unsafe
            # tile pairs.
            self._fused_common.append(
                (False, {**common, "k_per_batch": self._k2}))
            self._runner2 = make_sharded_stats_runner(
                self.mesh, majmin=False, **common, k_per_batch=self._k2)

        self._aux_dev = None
        self._orig_dev = None
        if self._windowed_packed and cfg.max_site_distance is not None:
            # Replicated original-index lookup for the permuted site-index
            # window mask (trailing pad rides the gj < n_sites validity
            # mask, so its fill value is irrelevant).
            op = np.zeros(self.plan.s_pad, dtype=np.int32)
            op[: self.n_sites] = self._site_perm
            (self._orig_dev,) = replicate(self.mesh, op)
        if majmin or hybrid:
            if sm is not None and site_counts is None:
                from ..core.sites import site_histogram_host_site_major

                site_counts = site_histogram_host_site_major(
                    sm.codes, self.n_sites, self.n_seqs)
            aux = mm.majmin_site_aux(
                None if sm is not None else alignment,
                self.plan.s_pad, counts=site_counts)
            (self._aux_dev,) = replicate(self.mesh, aux)

        if codes_pre is not None:
            self.codes_dev = codes_pre
            (self.weights_dev,) = replicate(self.mesh, weights_host)
        else:
            self.codes_dev, self.weights_dev = replicate(
                self.mesh, codes_host, weights_host)

        # Stripe tiles over shards, pad every shard to a whole number of
        # batches, and upload the whole plan once (sharded over the mesh
        # axis).  Each dispatch then addresses its batch by scalar index —
        # no per-batch host->device array uploads.  In hybrid mode the plan
        # splits into two phases (safe tile pairs -> factorized form, the
        # rest -> general form), striped independently and laid out
        # back-to-back per shard, so a batch index still addresses slice
        # [b*k, (b+1)*k) of the shard's plan buffer in BOTH phases.
        if self._hybrid_safe is None:
            phases = [self.plan]
        else:
            from dataclasses import replace as _replan

            safe = self._hybrid_safe
            phases = [
                _replan(self.plan, tile_i=self.plan.tile_i[safe],
                        tile_j=self.plan.tile_j[safe]),
                _replan(self.plan, tile_i=self.plan.tile_i[~safe],
                        tile_j=self.plan.tile_j[~safe]),
            ]
        from jax.sharding import NamedSharding, PartitionSpec as P

        plan_sharding = NamedSharding(self.mesh, P("tiles"))
        phase_ks = [k] + ([self._k2] if len(phases) == 2 else [])
        bufs, nb_list, epb_parts = [], [], []
        self._plan_host = []  # (ti_p, tj_p, em_p, k_p) per phase — lets
        # consumers recover a batch's tile coordinates WITHOUT fetching the
        # runner's bi/bj outputs.
        for ph, k_p in zip(phases, phase_ks):
            tile_i, tile_j, emit = stripe(ph, n_dev)
            per_shard = len(tile_i) // n_dev
            nb_p = cdiv(per_shard, k_p)
            pps = nb_p * k_p
            ti_p = np.zeros((n_dev, pps), dtype=np.int32)
            tj_p = np.zeros((n_dev, pps), dtype=np.int32)
            em_p = np.zeros((n_dev, pps), dtype=np.int32)
            for d in range(n_dev):
                src = slice(d * per_shard, (d + 1) * per_shard)
                ti_p[d, :per_shard] = tile_i[src]
                tj_p[d, :per_shard] = tile_j[src]
                em_p[d, :per_shard] = emit[src]
            bufs.append(tuple(
                jax.device_put(x.reshape(-1), plan_sharding)
                for x in (ti_p, tj_p, em_p)))
            nb_list.append(nb_p)
            self._plan_host.append((ti_p, tj_p, em_p, k_p))
            # Real (non-padding) tiles per batch, for truthful progress.
            epb_parts.append(em_p.reshape(n_dev, nb_p, k_p).sum(axis=(0, 2)))
        self.n_batches = sum(nb_list)
        # Batches [0, _n_batches_p0) dispatch self.runner against the
        # phase-0 plan buffer; the rest self._runner2 against the
        # (k2-sized) phase-1 buffer (hybrid only).
        self._n_batches_p0 = (nb_list[0] if self._hybrid_safe is not None
                              else self.n_batches)
        self.ti_dev, self.tj_dev, self.em_dev = bufs[0]
        self._plan2_dev = bufs[1] if len(bufs) == 2 else None
        self._emit_per_batch = np.concatenate(epb_parts)

    @staticmethod
    def required_padding(n_seqs: int, n_sites: int,
                         cfg: DriverConfig | None = None) -> tuple[int, int]:
        """``(s_pad, n_pad)`` a :class:`SiteMajorCodes` buffer must have to
        feed a session built with ``cfg`` — the same tile / seq-chunk
        resolution the constructor performs, so streaming ingest can
        allocate the padded buffer before decoding."""
        cfg = cfg or DriverConfig()
        if _resolve_engine(cfg.engine) != "int8":
            raise ValueError(
                "SiteMajorCodes input requires the site-major engine "
                f"(engine='auto'), got engine={cfg.engine!r}")
        tile = resolve_tile(cfg.tile)
        seq_chunk = resolve_seq_chunk(cfg.seq_chunk)
        return (cdiv(n_sites, tile) * tile,
                cdiv(n_seqs, seq_chunk) * seq_chunk)

    def _ensure_sm_dev(self, what: str):
        """Validate the site map for on-device distance work (int32 range,
        non-decreasing) and replicate the padded copy over the mesh —
        shared by the bp-window mask and :meth:`ld_decay`."""
        if self._sm_dev is not None:
            return self._sm_dev
        sm = self.site_map
        if sm.size and (sm.max() > np.iinfo(np.int32).max or sm.min() < 0):
            raise ValueError(f"{what} needs site_map positions that fit "
                             "int32 (the device distance dtype)")
        nondecr = (self._sm_orig_nondecr if self._site_perm is not None
                   else not bool((np.diff(sm) < 0).any()))
        if not nondecr:
            # e.g. a multi-chromosome VCF where POS resets: pair
            # "distances" across the reset would be negative or
            # meaningless — refuse rather than silently mis-bin.  With
            # unsafe-site packing active the check runs against the
            # INPUT order (the permuted map is non-monotonic by design;
            # per-pair |distance| is order-free).
            raise ValueError(
                f"{what} needs a non-decreasing site_map (positions "
                "restart mid-file — multi-chromosome input? run per "
                "chromosome)")
        s_pad = cdiv(self.n_sites, self.cfg.tile) * self.cfg.tile
        sm_pad = np.zeros(s_pad, dtype=np.int32)
        sm_pad[: self.n_sites] = sm  # padding sites have keep == False
        (self._sm_dev,) = replicate(self.mesh, sm_pad)
        return self._sm_dev

    def _fused_runner(self, phase: int, cap: int, wire_scale=None):
        """Stats runner variant that ALSO slot-compacts each shard's
        records inside the same program (``emit_capacity``) — built lazily
        per power-of-4 capacity bucket and cached by the runner registry,
        so streaming pays one dispatch per batch instead of two.
        ``wire_scale`` selects the compressed 12-byte record wire (see
        :meth:`stream`)."""
        flag, kw = self._fused_common[min(phase, len(self._fused_common) - 1)]
        return make_sharded_stats_runner(
            self.mesh, majmin=flag, emit_capacity=cap,
            wire_scale=wire_scale, **kw)

    def _wire_scale_for(self, decimals: int | None) -> int | None:
        """Resolve a ``decimals`` request to the packed-wire scale, or None
        when the compressed format cannot apply (tile-local indices need
        T <= 512 and a <= 2^14 tile batch — both true for every auto
        configuration; falling back to the f32 wire is OUTPUT-NEUTRAL
        because the quantizer equals the writer's round())."""
        if decimals is None:
            return None
        if not 0 <= int(decimals) <= 4:
            raise ValueError(
                f"decimals must be in 0..4 (text-output precision), got "
                f"{decimals!r}")
        if self.cfg.tile > 512:
            return None
        ks = [self.cfg.tiles_per_shard_batch]
        if self._k2:
            ks.append(self._k2)
        if max(ks) > (1 << 14):
            return None
        return 10 ** int(decimals)

    def _dispatch(self, b: int, r2_threshold=_UNSET, emit_capacity=None,
                  wire_scale=None):
        """Enqueue one batch (async — nothing is fetched).

        ``r2_threshold`` overrides the session default for this dispatch
        (``None`` = emit every surviving pair); it is a runtime scalar of
        the compiled program, so per-scan thresholds never recompile (the
        point of a device-resident serving session).  ``emit_capacity``
        selects the fused stats+records program (streaming scans)."""
        thr = self.cfg.r2_threshold if r2_threshold is _UNSET else r2_threshold
        thr = -np.inf if thr is None else thr
        # Hybrid plan: batches [0, _n_batches_p0) are the factorized-safe
        # tile pairs; the rest run the general per-pair kernel against the
        # separate (k2-sized) phase-1 plan buffer with a phase-local index.
        if b < self._n_batches_p0:
            phase, ti, tj, em = 0, self.ti_dev, self.tj_dev, self.em_dev
            runner = self.runner
        else:
            phase = 1
            runner = self._runner2
            ti, tj, em = self._plan2_dev
            b = b - self._n_batches_p0
        if emit_capacity:
            runner = self._fused_runner(phase, emit_capacity, wire_scale)
        return runner(
            self.codes_dev, self.weights_dev,
            ti, tj, em, b, thr,
            aux=self._aux_dev,
            sm_pad=(self._sm_dev
                    if self.cfg.max_bp_distance is not None else None),
            orig_pad=self._orig_dev,
        )

    def _start_extract_spec(self, dispatched):
        """Non-blocking extraction half.  A FUSED dispatch (10 outputs)
        already carries each shard's slot-compacted ``[cap, 5]`` record
        block inside the stats program itself — nothing extra to enqueue.
        Otherwise, when a speculative capacity has been learned, enqueue a
        separate gather-compact and start its host copy — no fetch, no
        host stall.  The learned bucket only ratchets up, so overflows
        (re-dispatched exactly in :meth:`_extract_records`) die out after
        the first batch of a new record-volume regime; capacities share
        ``_next_bucket``'s power-of-4 grid, so no extra program shapes are
        compiled.  Returns a ``(kind, cap, packed)`` spec triple."""
        if len(dispatched) > 9:
            packed = dispatched[9]                # [n_dev, cap, 5] sharded
            return "shards", int(packed.shape[1]), packed
        (tcnt, d_t, dp_t, r2_t, mask_t, bi_dev, bj_dev,
         _keep, _mom) = dispatched
        spec_cap = self._spec_cap
        if not spec_cap:
            return "none", 0, None
        gc_mesh = self.mesh if jax.process_count() > 1 else None
        _cnt_dev, spec_packed = gather_compact(
            d_t, dp_t, r2_t, mask_t, bi_dev, bj_dev,
            tile=self.cfg.tile, capacity=spec_cap, mesh=gc_mesh,
        )
        try:
            spec_packed.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass
        return "global", spec_cap, spec_packed

    def _extract_records(self, dispatched, spec, b=None,
                         wire_scale=None) -> LdRecords:
        """Blocking extraction half (stream() runs it one batch behind
        compute): materialize the [K] count — its copy started at
        dispatch, so no roundtrip is exposed — learn the speculative
        capacity, and accept the fused/speculative record block or
        re-dispatch an exact gather on overflow (the caller keeps the
        batch's stat tensors alive until here).  ``b``/``wire_scale``
        decode the compressed 12-byte wire (tile-local coordinates need
        the batch's host plan slice); the overflow path stays on the
        exact f32 gather, which is output-neutral (the wire quantizer
        equals the writer's round())."""
        kind, cap, packed = spec
        # Per-shard record counts ride the fused [n_dev, 4] moments output
        # (column 1 = thresholded pair count — the exact record
        # population), so extraction needs no [K] tile-count fetch at all.
        mom = _fetch(dispatched[8])
        per_shard = mom[:, 1]
        total = int(per_shard.sum())
        max_shard = int(per_shard.max()) if total else 0
        # Capacity learning is PER SHARD (the fused compaction packs each
        # shard's own records); on one device max_shard == total, so the
        # single-chip semantics are unchanged.  A TWO-BATCH sliding window
        # (not a pure ratchet) lets the capacity SHRINK after two
        # consecutive smaller batches: an oversized bucket learned in one
        # high-yield scan would otherwise poison every later low-yield
        # scan of the resident session with O(capacity * T) compaction and
        # a [capacity, 5] transfer per batch.
        if b is not None:
            self._batch_caps[b] = max_shard  # exact per-batch memory
        bucket = _next_bucket(max(1, max_shard))
        if bucket <= _SPEC_CAP_MAX:
            self._cap_hist = (self._cap_hist + [bucket])[-2:]
            self._spec_cap = max(self._cap_hist)
        elif max_shard:
            self._cap_hist = []
            # Record volume beyond speculation's regime: the compaction is
            # O(capacity * T), so a multi-million-record batch costs more
            # to re-gather speculatively than the roundtrip it would hide
            # (extraction is O(records)-bound there anyway).
            self._spec_cap = 0
        if total == 0:
            return self._records_from_flat(np.empty((0, 5), np.int32))
        if kind == "shards" and max_shard <= cap:
            w = int(packed.shape[-1])
            ph = _fetch(packed).reshape(self.n_dev, cap, w)
            if w == 3:
                return self._records_from_wire3(ph, per_shard, b, wire_scale)
            flat = np.concatenate(
                [ph[d, :int(c)] for d, c in enumerate(per_shard)], axis=0)
            return self._quantize(self._records_from_flat(flat), wire_scale)
        if kind == "global" and total <= cap:
            return self._quantize(self._finish_extract(total, packed),
                                  wire_scale)
        # Overflow (or un-learned first batch): exact global gather from
        # the still-alive stat tensors — the one path that pays a fetch.
        (_t, d_t, dp_t, r2_t, mask_t, bi_dev, bj_dev) = dispatched[:7]
        gc_mesh = self.mesh if jax.process_count() > 1 else None
        _cnt_dev, gp = gather_compact(
            d_t, dp_t, r2_t, mask_t, bi_dev, bj_dev,
            tile=self.cfg.tile, capacity=_next_bucket(total), mesh=gc_mesh,
        )
        return self._quantize(self._finish_extract(total, gp), wire_scale)

    @staticmethod
    def _quantize(rec: LdRecords, wire_scale) -> LdRecords:
        """Apply the wire's value contract to records that arrived via an
        exact-f32 fallback path (capacity overflow, un-learned first
        batch): a ``stream(decimals=d)`` consumer must see the SAME
        rounded values no matter which transport a batch took.  The f64
        product is exact (24 + <=14 mantissa bits) and ``np.round`` is
        half-even, so this equals both the device quantizer and CPython's
        ``round(x, d)`` bit-for-bit (including -0.0 for tiny negatives);
        D' rides exact in both transports."""
        if wire_scale is None or not len(rec):
            return rec
        q = lambda x: (np.round(x.astype(np.float64) * wire_scale)
                       / wire_scale).astype(np.float32)
        return LdRecords(pos_a=rec.pos_a, pos_b=rec.pos_b,
                         d=q(rec.d), d_prime=rec.d_prime, r2=q(rec.r2))

    def _finish_extract(self, total, packed) -> LdRecords:
        """Materialize one batch's GLOBALLY compacted records (a single
        fetch of the whole [cap, 5] int32 block, sites + bitcast values)."""
        if total == 0:
            return self._records_from_flat(np.empty((0, 5), np.int32))
        return self._records_from_flat(np.asarray(packed)[:total])

    def _records_from_flat(self, packed_h) -> LdRecords:
        """``[n, 5]`` int32 host rows (sites + bitcast D/D'/r2) ->
        :class:`LdRecords` in the caller's coordinates."""
        return self._records_from_arrays(
            packed_h[:, :2], packed_h[:, 2:].view(np.float32))

    def _records_from_wire3(self, ph, per_shard, b, scale) -> LdRecords:
        """Decode the compressed 12-byte wire: ``[n_dev, cap, 3]`` int32
        blocks -> :class:`LdRecords`.  Word 0 carries tile-local
        coordinates resolved against the batch's host-retained plan slice
        (shard-major, like the device programs' tile_i slices); word 1 the
        D/r2 fixed-point quanta (``round_fixed_exact`` — the decoded
        ``q / scale`` formats byte-identically to the f32 path); word 2
        the raw D' bits."""
        t = self.cfg.tile
        ti_h, tj_h, _em = self._batch_tiles_host(b)
        k_p = len(ti_h) // self.n_dev
        sites_l, vals_l = [], []
        for dev, c in enumerate(per_shard):
            blk = ph[dev, : int(c)]
            w0 = blk[:, 0].astype(np.uint32)
            kt = (w0 >> 18).astype(np.int64) + dev * k_p
            gi = ti_h[kt].astype(np.int64) * t + ((w0 >> 9) & 511)
            gj = tj_h[kt].astype(np.int64) * t + (w0 & 511)
            qd = (((blk[:, 1] & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int64)
            qr = (blk[:, 1].astype(np.uint32) >> 16).astype(np.int64)
            d = np.where(qd == -(1 << 15), np.float32(-0.0),
                         (qd / scale).astype(np.float32))
            r2 = (qr / scale).astype(np.float32)
            dp = np.ascontiguousarray(blk[:, 2]).view(np.float32)
            sites_l.append(np.stack([gi, gj], axis=1).astype(np.int32))
            vals_l.append(np.stack([d, dp, r2], axis=1).astype(np.float32))
        return self._records_from_arrays(
            np.concatenate(sites_l, axis=0), np.concatenate(vals_l, axis=0))

    def _records_from_arrays(self, all_sites, all_vals) -> LdRecords:
        """``(sites [n, 2] int32, values [n, 3] f32)`` -> LdRecords in the
        caller's coordinates (unsafe-site-packing permutation folded)."""
        total = len(all_sites)

        if self._site_perm is not None and total:
            # Packed internal order: internal i < j no longer implies
            # original kept-site order — swap each record's endpoints back
            # to the reference's (earlier site, later site) convention
            # (D/D'/r2 are symmetric under the swap, WeightedLD.py:260-280).
            p = self._site_perm
            oi, oj = p[all_sites[:, 0]], p[all_sites[:, 1]]
            flip = oi > oj
            a = np.where(flip, all_sites[:, 1], all_sites[:, 0])
            b = np.where(flip, all_sites[:, 0], all_sites[:, 1])
            all_sites = np.stack([a, b], axis=1)

        return LdRecords(
            pos_a=self.site_map[all_sites[:, 0]],
            pos_b=self.site_map[all_sites[:, 1]],
            d=all_vals[:, 0],
            d_prime=all_vals[:, 1],
            r2=all_vals[:, 2],
        )

    def _collect(self, dispatched) -> LdRecords:
        """Fetch + compact the records of a dispatched batch."""
        return self._extract_records(
            dispatched, self._start_extract_spec(dispatched))

    def run_batch(self, b: int) -> LdRecords:
        """Evaluate one tile batch and return its surviving records."""
        return self._collect(self._dispatch(b))

    @staticmethod
    def _prime(dispatched):
        """Start the device->host copies of a batch's small control
        outputs (per-tile counts, fused moments) at DISPATCH time: the
        transfer then begins the moment the batch finishes on device,
        instead of waiting for a later _fetch to request it."""
        idxs = (8, 9) if len(dispatched) > 9 else (8,)
        for idx in idxs:
            try:
                dispatched[idx].copy_to_host_async()
            except (AttributeError, NotImplementedError):
                return

    def _pipelined(self, start_batch: int = 0, r2_threshold=_UNSET,
                   fused: bool = False, wire_scale=None):
        """Yield (batch_index, dispatched) with batch b+1 already enqueued
        on-device while b's results travel to the host — the single
        double-buffering loop behind summarize/stream/matrices.

        ``fused=True`` (streaming): dispatch the stats+records program at
        the batch's learned capacity — read at each dispatch, so learning
        from batch b's count takes effect from batch b+2's dispatch on."""
        def cap(b):
            return self._batch_capacity(b) if fused else None

        pending = None
        for b in range(start_batch, self.n_batches):
            if pending is None:
                pending = self._dispatch(b, r2_threshold, cap(b), wire_scale)
                self._prime(pending)
            nxt = None
            if b + 1 < self.n_batches:
                nxt = self._dispatch(b + 1, r2_threshold, cap(b + 1),
                                     wire_scale)
                self._prime(nxt)
            yield b, pending
            pending = nxt

    def _batch_capacity(self, b: int) -> int | None:
        """Speculative per-shard compaction capacity for batch ``b``.

        Record counts are DETERMINISTIC per (input, threshold), so once a
        batch has run, its own last-seen per-shard max (+12.5% headroom,
        rounded onto a coarse grid — power-of-4 below 2048, 2048
        multiples above, bounding compiled program shapes) is the right
        capacity for every re-scan of the resident session — the global
        power-of-4 bucket wastes up to 4x of BOTH the O(cap*T/16) slot
        sweep and the [cap, w] device->host transfer.  Unknown batches fall back to the session-global
        two-batch window; a threshold change invalidates the memory
        (stream() handles that).  Overflow stays safe either way: the
        exact re-gather protocol runs whenever a true count exceeds the
        speculation."""
        known = self._batch_caps.get(b)
        if known is None:
            return self._spec_cap or None
        if known == 0:
            # Zero-record batch: keep the fused program (one dispatch) at
            # the minimum capacity — the compaction cond skips, and the
            # [256, w] zero block costs ~nothing to ship.
            return 256
        padded = known + (known >> 3)
        if padded < 2048:
            cap = _next_bucket(padded)
        else:
            # Quarter-octave grid {1, 1.25, 1.5, 1.75} x 2^k: <= 25%
            # overshoot (vs up to 4x for the global power-of-4 bucket)
            # while the number of DISTINCT compiled fused-program shapes
            # stays bounded at ~4 per power of two — a flat 2048-multiple
            # grid could demand thousands of compiles from a diverse-
            # count stream.
            k_exp = max(padded.bit_length() - 1, 11)
            base = 1 << k_exp
            cap = base + (-(-(padded - base) // (base >> 2))) * (base >> 2)
        if cap > _SPEC_CAP_MAX:
            return self._spec_cap or None
        return cap

    def _pipelined_reduce(self, per_batch, r2_threshold=_UNSET):
        """Yield ``(b, np.ndarray)`` for ``per_batch(b, dispatched)`` (a
        device-array-returning reduction over one batch), materialized ONE
        batch behind compute: the result's device->host copy starts the
        moment it is enqueued, so by materialization time the bytes have
        landed and no host fetch is exposed as a blocking roundtrip
        — the reduction analog of :meth:`stream`'s extraction pipeline."""
        single = jax.process_count() == 1
        pending = None
        for b, dispatched in self._pipelined(r2_threshold=r2_threshold):
            out = per_batch(b, dispatched)
            if single:  # multi-process shards are gathered by _fetch
                try:
                    out.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
            if pending is not None:
                yield pending[0], _fetch(pending[1])
            pending = (b, out)
        if pending is not None:
            yield pending[0], _fetch(pending[1])

    def summarize(self, r2_threshold=_UNSET) -> dict:
        """Whole-triangle reduction-only scan: pair counts and r2 moments,
        with O(1) host traffic per batch — the pod-scale 'stats-only' mode
        (no record materialization anywhere).  The moments come fused out of
        the runner dispatch itself (one program per batch, double-buffered).

        ``r2_threshold`` overrides the session default for this scan only
        (runtime scalar — no recompilation)."""
        n_pairs = 0
        n_over = 0
        r2_sum = 0.0
        r2_max = -np.inf
        # Single fused [n_dev, 4] int32 array per batch (f32 moments
        # bitcast), copy started at dispatch (_prime) and materialized one
        # batch behind compute — no exposed roundtrips.
        for _b, mom in self._pipelined_reduce(
                lambda b, d: d[8], r2_threshold=r2_threshold):
            mc = mom[:, :2]
            mv = mom[:, 2:].view(np.float32)
            n_pairs += int(mc[:, 0].sum())
            n_over += int(mc[:, 1].sum())
            r2_sum += float(mv[:, 0].sum())
            r2_max = max(r2_max, float(mv[:, 1].max()))
        return {
            "n_sequences": self.n_seqs,
            "n_sites": self.n_sites,
            "n_pairs": n_pairs,
            "n_over_threshold": n_over,
            "r2_sum_over_threshold": r2_sum,
            "r2_max": r2_max if n_pairs else None,
        }

    def ld_decay(self, edges) -> dict:
        """LD-decay curve: per distance bin, the kept-pair count, r2 sum
        and mean, plus the |D'| sum/mean — the classic 'r2 (and D') vs
        distance' analyses, computed ON DEVICE in one pass per batch
        (O(B) host traffic).

        |D'| statistics cover kept pairs whose D' is finite
        (``n_d_prime_finite`` per bin): the reference's zero-denominator
        fallback yields NaN D' for degenerate pairs
        (``WeightedLD.py:269-277``), which still count toward r2.

        Distance is measured in ``site_map`` coordinates — base pairs for
        VCF input, original column indices for FASTA.  ``edges`` is an
        ascending sequence; bin b covers ``edges[b] <= dist <
        edges[b+1]``.  The session r2 threshold is ignored (every
        surviving pair contributes)."""
        edges = validate_decay_edges(edges)
        self._ensure_sm_dev("ld_decay")
        runner = make_decay_runner(self.mesh, tile=self.cfg.tile,
                                   edges=edges)
        nb = len(edges) - 1
        counts = np.zeros(nb, dtype=np.int64)
        sums = np.zeros(nb, dtype=np.float64)
        dp_sums = np.zeros(nb, dtype=np.float64)
        dp_counts = np.zeros(nb, dtype=np.int64)
        for _b, packed in self._pipelined_reduce(
                lambda b, d: runner(d[3], d[2], d[7], d[5], d[6],
                                    self._sm_dev)):
            packed = packed.reshape(-1, nb, 4)            # [n_dev, B, 4]
            counts += packed[:, :, 0].astype(np.int64).sum(axis=0)
            sums += np.ascontiguousarray(packed[:, :, 1]).view(
                np.float32).astype(np.float64).sum(axis=0)
            dp_sums += np.ascontiguousarray(packed[:, :, 2]).view(
                np.float32).astype(np.float64).sum(axis=0)
            dp_counts += packed[:, :, 3].astype(np.int64).sum(axis=0)
        return {
            "edges": list(edges),
            "n_pairs": counts.tolist(),
            "r2_sum": sums.tolist(),
            "r2_mean": [float(s / c) if c else None
                        for s, c in zip(sums, counts)],
            "abs_d_prime_sum": dp_sums.tolist(),
            "abs_d_prime_mean": [float(s / c) if c else None
                                 for s, c in zip(dp_sums, dp_counts)],
            "n_d_prime_finite": dp_counts.tolist(),
        }

    def r2_histogram(self, edges) -> dict:
        """Histogram of r2 over all surviving pairs — the natural way to
        pick an output/pruning threshold.  ``edges`` is an ascending
        sequence of floats; bin b covers ``edges[b] <= r2 < edges[b+1]``
        (use an upper edge > 1.0 to include perfect LD).  One on-device
        pass per batch, O(bins) host traffic; the session r2 threshold is
        ignored."""
        edges = validate_hist_edges(edges)
        runner = make_hist_runner(self.mesh, edges=edges)
        nb = len(edges) - 1
        counts = np.zeros(nb, dtype=np.int64)
        for _b, packed in self._pipelined_reduce(
                lambda b, d: runner(d[3], d[7])):
            counts += packed.reshape(-1, nb).astype(np.int64).sum(axis=0)
        return {"edges": list(edges), "n_pairs": counts.tolist()}

    def prune(self, r2_threshold: float, rule: str = "maf",
              on_progress: Callable[[Progress], None] | None = None,
              ) -> np.ndarray:
        """Greedy LD pruning (the PLINK ``--indep-pairwise`` idea): return
        the ``site_map`` positions of a subset of sites in which no
        surviving pair has ``r2 > r2_threshold`` (within the session's
        ``max_site_distance`` window, if one is set).

        Deterministic greedy sweep over conflicting pairs in (pos_a,
        pos_b) order; when both endpoints are still kept, ``rule="maf"``
        drops the endpoint with the LOWER minor-allele frequency (ties ->
        the later site; MAF uses the reference's all-minor definition,
        ``WeightedLD.py:79-87``), ``rule="first"`` always drops the later
        site.  Post-condition (exact, since pairwise r2 does not change
        when other sites are removed): no kept pair in the scanned plan
        exceeds the threshold.

        Host memory is O(#pairs above threshold) — use a window and/or a
        meaningful threshold at chromosome scale."""
        if rule not in ("maf", "first"):
            raise ValueError(f"rule must be maf|first, got {rule!r}")
        if not np.isfinite(r2_threshold):
            raise ValueError(
                f"r2_threshold must be finite, got {r2_threshold!r}")
        pos_to_idx = {int(p): i for i, p in enumerate(self.site_map)}
        if len(pos_to_idx) != self.n_sites:
            raise ValueError("prune needs unique site_map positions "
                             "(multi-chromosome input? run per chromosome)")
        maf = self._maf() if rule == "maf" else None
        pa_parts, pb_parts = [], []
        for _b, rec in self.stream(r2_threshold=float(r2_threshold),
                                   on_progress=on_progress):
            pa_parts.append(np.asarray(rec.pos_a))
            pb_parts.append(np.asarray(rec.pos_b))
        kept = np.ones(self.n_sites, dtype=bool)
        if pa_parts:
            pa = np.concatenate(pa_parts)
            pb = np.concatenate(pb_parts)
            order = np.lexsort((pb, pa))
            pa, pb = pa[order], pb[order]
            for qa, qb in zip(pa, pb):
                a, b = pos_to_idx[int(qa)], pos_to_idx[int(qb)]
                if kept[a] and kept[b]:
                    if rule == "maf" and maf[a] < maf[b]:
                        kept[a] = False
                    else:
                        kept[b] = False
        if self._site_perm is not None:
            # Report surviving positions in the caller's INPUT order, not
            # the packed internal order.
            p = self._site_perm
            sm_in = np.empty_like(self.site_map)
            sm_in[p] = self.site_map
            kept_in = np.zeros_like(kept)
            kept_in[p] = kept
            return sm_in[kept_in]
        return self.site_map[kept]

    def _maf(self) -> np.ndarray:
        """Per-site minor-allele fraction (reference all-minor definition,
        ``WeightedLD.py:79-87``), computed once and cached; the host
        alignment reference is released afterwards."""
        if self._maf_cache is None:
            if self._codes_sm is not None:
                from ..core.sites import site_histogram_host_site_major

                counts = site_histogram_host_site_major(
                    self._codes_sm.codes, self.n_sites, self.n_seqs
                )
            elif self._alignment is not None:
                from ..core.sites import site_histogram_host

                counts = site_histogram_host(self._alignment)   # [S, 5]
            else:
                raise RuntimeError("MAF already released; internal error")
            major = counts.max(axis=1)
            total = counts.sum(axis=1)
            self._maf_cache = (total - major) / np.maximum(total, 1)
            self._alignment = None
        return self._maf_cache

    def top_pairs(self, k: int) -> LdRecords:
        """Global top-``k`` surviving pairs by r2, descending — a
        threshold-free serving query (capability beyond the reference:
        'show me the strongest LD' without guessing a cutoff).

        Selection runs ON DEVICE (per-shard ``lax.top_k`` over each
        batch's kept pairs), so host traffic is O(n_dev * k) per batch
        regardless of how many pairs the scan covers.  The session's r2
        threshold is ignored — every surviving pair competes.  Ties at the
        k-th value are broken arbitrarily."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        runner = make_topk_runner(self.mesh, tile=self.cfg.tile, k_out=k)
        parts = []
        for _b, packed in self._pipelined_reduce(
                lambda b, d: runner(d[1], d[2], d[3], d[7], d[5], d[6])):
            parts.append(packed.reshape(-1, 5))
        cand = np.concatenate(parts, axis=0)
        sites = cand[:, :2]
        vals = cand[:, 2:].view(np.float32)
        ok = vals[:, 2] > -np.inf          # drop unfilled top-k slots
        sites, vals = sites[ok], vals[ok]
        order = np.argsort(-vals[:, 2], kind="stable")[:k]
        sites, vals = sites[order], vals[order]
        if self._site_perm is not None and len(sites):
            # Restore the (earlier site, later site) endpoint convention
            # under unsafe-site packing (see _finish_extract).
            p = self._site_perm
            oi, oj = p[sites[:, 0]], p[sites[:, 1]]
            flip = oi > oj
            a = np.where(flip, sites[:, 1], sites[:, 0])
            b = np.where(flip, sites[:, 0], sites[:, 1])
            sites = np.stack([a, b], axis=1)
        return LdRecords(
            pos_a=self.site_map[sites[:, 0]],
            pos_b=self.site_map[sites[:, 1]],
            d=vals[:, 0],
            d_prime=vals[:, 1],
            r2=vals[:, 2],
        )

    def _batch_tiles_host(self, b: int):
        """Host-side ``(tile_i, tile_j, emit)`` [K] vectors for global batch
        ``b`` — the same values the dispatched bi/bj device outputs carry
        (shard d's rows of the striped plan slice ``[b*k, (b+1)*k)``,
        concatenated in device order), computed from the retained plan so
        consumers never pay device fetches for tile coordinates."""
        ph = 0
        if len(self._plan_host) == 2 and b >= self._n_batches_p0:
            ph, b = 1, b - self._n_batches_p0
        ti_p, tj_p, em_p, k_p = self._plan_host[ph]
        sl = slice(b * k_p, (b + 1) * k_p)
        return (ti_p[:, sl].reshape(-1), tj_p[:, sl].reshape(-1),
                em_p[:, sl].reshape(-1))

    def matrices(self, dtype=np.float32) -> dict[str, np.ndarray]:
        """Assemble full square LD matrices (a capability beyond the
        reference, for heatmaps / downstream matrix consumers).

        Returns ``{"d", "d_prime", "r2": [S, S] ``dtype`` (NaN where the
        pair was skipped or below the diagonal), "keep": [S, S] bool}``.
        Host memory is O(S^2); the tile computation itself streams exactly
        like :meth:`stream` (the r2 threshold is ignored — matrices are
        complete).

        ``dtype``: ``float32`` (default — the engine's exact stats),
        ``float16``, or ``bfloat16``.  The reduced-precision exports
        downcast ON DEVICE before the device->host copies, HALVING the
        API's transport bytes; values round to within 2^-11 (f16) / 2^-8
        (bf16) relative, far above the 4-dp text-output floor but plenty
        for heatmaps and thresholding.

        The O(pairs) host traffic is latency-engineered like the record
        path: each batch's four stat tensors start their device->host
        copies asynchronously at dispatch, tile coordinates come from the
        host-retained plan (no bi/bj fetches), and assembly runs one batch
        BEHIND compute, so by materialization time the bytes have landed
        and no fetch blocks on a roundtrip."""
        dt = np.dtype(dtype)
        allowed = (np.dtype(np.float32), np.dtype(np.float16),
                   np.dtype(jnp.bfloat16))
        if dt not in allowed:
            raise ValueError(
                f"dtype must be float32, float16, or bfloat16, got {dtype!r}")
        s = self.n_sites
        t = self.cfg.tile
        out = {
            k: np.full((s, s), np.nan, dtype=dt)
            for k in ("d", "d_prime", "r2")
        }
        keep_m = np.zeros((s, s), dtype=bool)

        def assemble(b, tensors):
            d_h, dp_h, r2_h, keep_h = (_fetch(x) for x in tensors)
            bi_h, bj_h, em_h = self._batch_tiles_host(b)
            vals = {"d": d_h, "d_prime": dp_h, "r2": r2_h}
            for kk in np.nonzero(em_h)[0]:  # padding tiles cost nothing
                i0, j0 = int(bi_h[kk]) * t, int(bj_h[kk]) * t
                if i0 >= s or j0 >= s:
                    continue
                h, w = min(t, s - i0), min(t, s - j0)
                km = keep_h[kk, :h, :w]     # diagonal/skip rules folded in
                if not km.any():
                    continue
                keep_m[i0:i0 + h, j0:j0 + w] |= km
                for key, v in vals.items():
                    np.copyto(out[key][i0:i0 + h, j0:j0 + w],
                              v[kk, :h, :w], where=km)

        pending = None
        for b, dispatched in self._pipelined():
            (_tcnt, d_t, dp_t, r2_t, _mask, _bi, _bj, keep_t, _mom) = (
                dispatched
            )
            if dt != np.float32:
                # Device-side downcast before the async copies: the export
                # precision is the caller's contract, so ship half the bytes.
                d_t, dp_t, r2_t = (x.astype(dt) for x in (d_t, dp_t, r2_t))
            tensors = (d_t, dp_t, r2_t, keep_t)
            if jax.process_count() == 1:  # multi-process: _fetch gathers
                for x in tensors:
                    try:
                        x.copy_to_host_async()
                    except (AttributeError, NotImplementedError):
                        break
            if pending is not None:
                assemble(*pending)
            pending = (b, tensors)
        if pending is not None:
            assemble(*pending)
        out["keep"] = keep_m
        if self._site_perm is not None:
            # Internal (packed) order -> the caller's kept-site order:
            # M_orig[perm[k], perm[l]] = M_int[k, l], then fold entries
            # that land below the diagonal back into the upper triangle
            # (the matrices' documented convention).
            p = self._site_perm
            ix = np.ix_(p, p)
            for key in ("d", "d_prime", "r2"):
                m = np.full_like(out[key], np.nan)
                m[ix] = out[key]
                out[key] = m
            km = np.zeros_like(keep_m)
            km[ix] = keep_m
            low = np.nonzero(np.tril(km, k=-1))
            if low[0].size:
                for key in ("d", "d_prime", "r2"):
                    out[key][low[1], low[0]] = out[key][low]
                    out[key][low] = np.nan
                km[low[1], low[0]] = True
                km[low] = False
            out["keep"] = km
        return out

    def stream(
        self,
        start_batch: int = 0,
        on_progress: Callable[[Progress], None] | None = None,
        r2_threshold=_UNSET,
        decimals: int | None = None,
    ) -> Iterator[tuple[int, LdRecords]]:
        """Stream compacted records batch by batch.  ``r2_threshold``
        overrides the session default for this scan only (runtime scalar —
        no recompilation).

        ``decimals`` (0..4): the caller consumes the records as
        ``decimals``-digit text (the TSV writers) — records then travel in
        a compressed 12-byte fixed-point wire format (40% fewer transport
        bytes than sites + f32 stats; D' rides as raw f32 bits).  The
        device quantizer is exactly Python's ``round(x, decimals)``
        (``round_fixed_exact``), so the formatted output is
        BYTE-IDENTICAL to the default — the yielded record values are the
        rounded decimals instead of raw f32.  ``None`` (default) keeps
        exact f32 values — the analysis-API contract.

        Extraction is FULLY deferred one batch behind compute: batch b's
        speculative gather-compact is enqueued (and its host copy started)
        with no host read at all, and its [K] count — whose copy began at
        dispatch — is materialized only while batch b+1 computes, by which
        time the bytes have landed.  The batch's stat tensors stay alive
        one pipeline step so a speculative-capacity overflow can still
        re-dispatch an exact gather (the only path that ever exposes a
        roundtrip, and it dies out after one batch of a new record-volume
        regime)."""
        t0 = time.monotonic()
        last_report = t0
        tiles_done = 0
        records_emitted = 0
        t2 = self.cfg.tile * self.cfg.tile
        # Evaluated work = emitted (non-padding) tiles; padding tiles are
        # free.  This stays truthful under r2 thresholds and windowed plans.
        tiles_total = self.plan.n_tiles
        pending: tuple | None = None  # (b, dispatched, spec_cap, spec_packed)

        def progress(b):
            nonlocal last_report
            now = time.monotonic()
            if on_progress and (
                now - last_report > self.cfg.progress_every_s
                or b == self.n_batches - 1
            ):
                on_progress(Progress(
                    pairs_done=tiles_done * t2,
                    pairs_total=tiles_total * t2,
                    records_emitted=records_emitted,
                    elapsed_s=now - t0,
                ))
                last_report = now

        # Compute double-buffers via _pipelined; extraction adds a second,
        # one-batch-deep stage on top (pending holds the batch's dispatched
        # stat tensors — up to three batches of [K, T, T] outputs are alive
        # at once, covered by the tiles_per_shard_batch HBM budget).
        wire = self._wire_scale_for(decimals)
        # Per-batch capacity memory is only valid for the threshold it was
        # learned under (record counts are threshold-dependent).
        thr_now = (self.cfg.r2_threshold if r2_threshold is _UNSET
                   else r2_threshold)
        if self._caps_thr is _UNSET or self._caps_thr != thr_now:
            self._batch_caps = {}
            self._caps_thr = thr_now

        def emit(pending):
            nonlocal records_emitted, tiles_done
            pb, dispatched, spec = pending
            records = self._extract_records(dispatched, spec, pb, wire)
            records_emitted += len(records)
            tiles_done += int(self._emit_per_batch[pb])
            progress(pb)
            return pb, records

        for b, dispatched in self._pipelined(start_batch, r2_threshold,
                                             fused=True, wire_scale=wire):
            spec = self._start_extract_spec(dispatched)
            if pending is not None:
                yield emit(pending)
            pending = (b, dispatched, spec)
        if pending is not None:
            yield emit(pending)


def stream_ld_records(
    alignment: np.ndarray,
    weights: np.ndarray,
    site_map: np.ndarray,
    cfg: DriverConfig | None = None,
    mesh=None,
    start_batch: int = 0,
    on_progress: Callable[[Progress], None] | None = None,
    decimals: int | None = None,
) -> Iterator[tuple[int, LdRecords]]:
    """Yield ``(batch_idx, records)`` for every tile batch of the triangle.

    One-shot convenience wrapper over :class:`LdSession`.
    """
    session = LdSession(alignment, weights, site_map, cfg, mesh)
    yield from session.stream(start_batch=start_batch,
                              on_progress=on_progress, decimals=decimals)


def collect_ld_records(
    alignment: np.ndarray,
    weights: np.ndarray,
    site_map: np.ndarray,
    cfg: DriverConfig | None = None,
    mesh=None,
) -> LdRecords:
    """Run the full triangle and concatenate all records (small/medium S)."""
    parts = [r for _, r in stream_ld_records(alignment, weights, site_map, cfg, mesh)]
    if not parts:
        return LdRecords(*(np.empty(0) for _ in range(5)))
    return LdRecords(
        pos_a=np.concatenate([p.pos_a for p in parts]),
        pos_b=np.concatenate([p.pos_b for p in parts]),
        d=np.concatenate([p.d for p in parts]),
        d_prime=np.concatenate([p.d_prime for p in parts]),
        r2=np.concatenate([p.r2 for p in parts]),
    )


# ---------------------------------------------------------------------------
# Checkpointed TSV writing
# ---------------------------------------------------------------------------


def run_to_tsv(
    alignment: np.ndarray,
    weights: np.ndarray,
    site_map: np.ndarray,
    out_path: str | Path,
    cfg: DriverConfig | None = None,
    mesh=None,
    checkpoint: bool = True,
    ndigits: int = 4,
    on_progress: Callable[[Progress], None] | None = None,
    timer=None,
    annot=None,
) -> int:
    """Stream the triangle to a TSV file with batch-level resume.

    ``annot`` (an :class:`io.writer.PairAnnot`) switches rows and header to
    the PLINK-style format; it participates in the checkpoint fingerprint,
    so a resume cannot silently mix the two formats in one file.

    Multi-process aware: under a distributed runtime every process drives
    its own shards (the per-batch fetches are collectives, so all
    processes iterate the same batches), but only process 0 touches
    ``out_path`` and the checkpoint — the others stream into the null
    device.  A pod launcher can therefore hand every process the SAME
    command line (SURVEY §2.3; the reference is a CLI, ``main.rs:121-213``).

    State file ``<out>.ckpt.json`` records the last completed batch plus a
    fingerprint of the run (config + input digests); on restart, completed
    batches are skipped and the TSV is truncated to the checkpointed byte
    offset (torn batches are rewritten).  A resume whose config or input
    does not match the checkpoint is refused rather than silently mixing
    two different tile plans into one file.  The fingerprint covers the
    RESOLVED tile/seq_chunk/batch values, so a checkpoint taken under
    auto policies may refuse to resume after an upgrade that changes
    those policies — pass the previous run's explicit ``tile``/
    ``seq_chunk``/``tiles_per_shard_batch`` (recorded in this module's
    resolved ``session.cfg``) to resume it, or delete the checkpoint to
    start over.

    Returns the number of records written.
    """
    import hashlib

    from ..io.writer import open_text_output, pair_header, write_pairs

    header_line = pair_header(annot)

    out_path = Path(out_path)
    # A checkpointed .gz output is written as INDEPENDENT deterministic
    # gzip members (header, then one member per checkpoint segment):
    # concatenated members are a single valid gzip stream, so readers see
    # one file while resume truncates at a recorded member boundary — the
    # byte-offset semantics a single gzip stream cannot offer
    # (GzipMemberWriter).  A resumed run byte-equals an uninterrupted
    # checkpointed run; the non-checkpoint .gz path stays a single member.
    is_gz = str(out_path).endswith(".gz")
    ckpt_path = out_path.with_suffix(out_path.suffix + ".ckpt.json")

    # Build the session FIRST and fingerprint its RESOLVED plan: batch
    # indices in the checkpoint are only meaningful for one concrete tile
    # striping, which depends on the resolved tile, the resolved
    # tiles-per-batch (auto: platform- and threshold-dependent), the
    # resolved engine, and the mesh/process geometry — fingerprinting the
    # raw config (tile=None, engine="auto", ...) would let a resume on a
    # different mesh or platform silently interleave two different tile
    # plans into one file.  This also runs the O(N*S) plane-detection scan
    # exactly once (inside the session) instead of once per fingerprint.
    from .profiling import StageTimer

    timer = timer or StageTimer()
    with timer.stage("upload"):
        session = LdSession(alignment, weights, site_map,
                            cfg or DriverConfig(), mesh)
    cfg_r = session.cfg
    # Input digest source: the padded site-major buffer for streamed
    # ingest, the raw matrix otherwise.  The two fingerprints for the same
    # file intentionally differ (row sampling covers different bytes) —
    # a checkpoint must be resumed under the same ingest mode.
    aln_arr = (alignment.codes if isinstance(alignment, SiteMajorCodes)
               else alignment)
    h = hashlib.sha256()
    h.update(repr((
        cfg_r.tile, cfg_r.tiles_per_shard_batch, cfg_r.r2_threshold,
        cfg_r.max_site_distance, cfg_r.max_bp_distance, cfg_r.cross_split,
        session.engine, cfg_r.seq_chunk,
        cfg_r.weight_quant,  # quantized r2 differs at the 4-dp quantum:
                            # never mix modes in one resumed TSV
        session.n_dev, jax.process_count(),
        (session.n_seqs, session.n_sites), ndigits,
        header_line,  # output format: never mix tsv/plink rows in one file
    )).encode())
    # Full-matrix digest, streamed in ~16 MB row chunks: sha256 runs at
    # GB/s host-side — negligible next to the upload — and sampling
    # (the old every-64th-row digest) would let a corrupted/edited row
    # between samples resume a checkpoint silently against changed data.
    row_bytes = max(1, int(np.prod(aln_arr.shape[1:])) * aln_arr.itemsize)
    step = max(1, (1 << 24) // row_bytes)
    for r0 in range(0, aln_arr.shape[0], step):
        h.update(np.ascontiguousarray(aln_arr[r0:r0 + step]).tobytes())
    h.update(session.weights.tobytes())  # covers weights=None (on-device)
    h.update(np.asarray(site_map).tobytes())
    fingerprint = h.hexdigest()

    # Resolved-plan echo: written into the checkpoint so a mismatch error
    # can tell the user exactly which explicit flags reproduce the plan the
    # checkpoint was taken under (the auto tile/seq_chunk/batch policies
    # can change across upgrades, which would otherwise strand a pod run's
    # in-flight checkpoint behind an opaque "delete it" error).
    resolved = {
        "tile": cfg_r.tile,
        "seq_chunk": cfg_r.seq_chunk,
        "tiles_per_shard_batch": cfg_r.tiles_per_shard_batch,
        "engine": session.engine,
        "weight_quant": cfg_r.weight_quant,
    }

    # The session build above touched the backend, so process_count() is
    # safe here; only process 0 owns the output file and checkpoint.
    writer = jax.process_count() == 1 or jax.process_index() == 0

    start_batch = 0
    offset = None
    n_written = 0
    if writer and checkpoint and ckpt_path.exists() and out_path.exists():
        state = json.loads(ckpt_path.read_text())
        if state.get("fingerprint") != fingerprint:
            was = state.get("resolved")
            hint = (
                "; the checkpoint ran with resolved "
                f"tile={was['tile']} seq_chunk={was['seq_chunk']} "
                f"tiles_per_shard_batch={was['tiles_per_shard_batch']} "
                f"engine={was['engine']} — re-run with those as explicit "
                "flags (--tile/--seq-chunk/--tiles-per-batch) to resume it, "
                "or delete the checkpoint to start over"
                if was else "; delete it to start over"
            )
            raise RuntimeError(
                f"{ckpt_path}: checkpoint belongs to a different run "
                f"(config or input changed){hint}"
            )
        start_batch = state["next_batch"]
        offset = state["byte_offset"]
        n_written = state["n_records"]
        log.info("resuming at batch %d (%d records already written)",
                 start_batch, n_written)
    if jax.process_count() > 1:
        # Every process MUST iterate the same batches (the per-batch fetches
        # all-gather across processes), but only the output process has the
        # checkpoint file — broadcast its resume state to the others so the
        # returned record counts agree everywhere.
        from jax.experimental import multihost_utils

        start_batch, n_written = (int(v) for v in
                                  multihost_utils.broadcast_one_to_all(
                                      np.asarray([start_batch, n_written],
                                                 np.int64)))

    if not writer:
        import os

        fh = open(os.devnull, "w")
    elif is_gz and checkpoint:
        from ..io.writer import GzipMemberWriter

        fh = GzipMemberWriter(out_path, append_at=offset)
        if offset is None:
            fh.write(header_line + "\n")
            fh.flush()  # header = its own member, so batch-0 resume works
    elif offset is None:
        fh = open_text_output(out_path)
        fh.write(header_line + "\n")
    else:
        fh = open(out_path, "r+")
        fh.truncate(offset)
        fh.seek(offset)

    with fh, timer.stage("scan+write"):
        for b, rec in session.stream(
            start_batch=start_batch, on_progress=on_progress,
            # Text output at <= 4 decimals rides the compressed record
            # wire (byte-identical output — stream() docstring).
            decimals=ndigits if 0 <= ndigits <= 4 else None,
        ):
            # Records are replicated across processes (gathered on every
            # host), so n_written agrees everywhere even though only the
            # writer's bytes land in the real file.
            write_pairs(rec, fh, ndigits=ndigits, header=False, annot=annot)
            n_written += len(rec)
            if checkpoint and writer:
                fh.flush()
                ckpt_path.write_text(json.dumps({
                    "next_batch": b + 1,
                    "byte_offset": fh.tell(),
                    "n_records": n_written,
                    "fingerprint": fingerprint,
                    "resolved": resolved,
                }))
    if writer and ckpt_path.exists():
        ckpt_path.unlink()
    return n_written
