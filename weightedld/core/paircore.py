"""The weighted-LD pair engine as dense tensor algebra (f32 reference path).

This module is the numerical heart of the framework.  It reformulates the
reference's per-pair scalar loop (``WeightedLD.py:154-284``) as dense linear
algebra over *tiles* of sites, so that the O(S^2 * N) all-pairs reduction is a
batch of matrix products:

For a tile of sites ``A`` (T_a sites) and a tile ``B`` (T_b sites):

* ``Jw[a, b, s, t] = sum_n w_n * [codes[n,a]==s] * [codes[n,b]==t]`` — the
  weighted joint haplotype table over alleles ``s, t in 0..4``.  Sequences
  with code 5 (unknown) at either site contribute to no (s, t) cell, so the
  reference's first filtering pass (``WeightedLD.py:183-186``) is implicit.
* ``Ju`` — the same contraction with unit weights.  Its marginals
  ``cnt_a[a,b,s] = sum_t Ju[a,b,s,t]`` are exactly the post-filter per-pair
  symbol counts the reference recomputes per pair with ``np.unique``
  (``WeightedLD.py:194-211``) — no per-pair histogram pass needed.

Both contractions are one-hot matmuls with contraction length N, run in f32
at ``Precision.HIGHEST`` (this is the exact reference path; the fast engine
is the integer one in :mod:`weightedld.core.tile_engine`).  Everything
downstream of the contraction (major / dominant-minor determination, the
second filtering pass, skip rules, and the D / D' / r^2 algebra) is
branch-free element-wise arithmetic over the (T_a, T_b) pair tile,
implemented in :func:`finalize_pair_tile`.

Parity notes (vs ``WeightedLD.py``):
* Major / dominant-minor tie-breaking picks the smallest symbol code —
  matching the reference's Rust scan (``lib.rs:126-140``) and the Python
  comment's stated intent ("if two are equal takes first",
  ``WeightedLD.py:208``).  N.b. the Python reference's ACTUAL tie order is
  unspecified: ``np.argsort(-counts)`` (``:204,209``) uses numpy's default
  quicksort, which is not stable — on count ties the picked symbol is
  content- and numpy-version-dependent (e.g. counts ``[1,2,4,4]`` yield
  major=code 3 but ``[2,4,4]`` major=code 2).  On a top-2 tie only D's
  sign is affected (relabeling; D'/r^2 invariant).  We encode the
  deterministic rule as ``count * 8 + (5 - code)`` and take an argmax.
* Skip rules: (1) fewer than two distinct symbols at either site after the
  unknown-sequence filter (``WeightedLD.py:196-201``); (2) ``round(PA,1)==1.0``
  or ``round(PB,1)==1.0`` (``WeightedLD.py:234-237``) — PA there is a
  ``np.float64``, and ``np.float64.__round__`` scales by 10 before
  rounding, so ``double(0.95) * 10`` lands exactly on 9.5 and half-evens
  UP: the predicate is exactly ``P >= double(0.95)``.  (Python-float
  ``round(0.95, 1)`` is 0.9 — decimal-correct rounding — so a
  plain-float reimplementation would wrongly KEEP the exact-boundary
  pair, e.g. PA = 19/20 under unit weights.  Pinned by
  ``test_pa_095_boundary_pair_is_skipped``.); (3) pairs whose
  count-major allele retains zero
  post-filter weight at either site are skipped — there the reference's
  masked PA/PB makes its own ``round(PA, 1)`` raise TypeError
  (``WeightedLD.py:227-235``), i.e. it defines no output (this also covers
  the empty post-filter set).
* D is the mean of the four algebraically-equal estimates
  (``WeightedLD.py:260-266``); D' uses the sign-dependent denominator with the
  zero-denominator max<->min fallback (``WeightedLD.py:269-277``); r^2 is
  ``D^2 / (PA*Pa*PB*Pb)`` (``WeightedLD.py:280``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .encode import N_ALLELES


class PairStats(NamedTuple):
    """Per-pair LD statistics over a tile: all arrays shaped [T_a, T_b]."""

    d: jnp.ndarray
    d_prime: jnp.ndarray
    r2: jnp.ndarray
    keep: jnp.ndarray  # bool: pair survived every skip rule


def one_hot_alleles(codes: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """``[N, T] -> [N, T, 5]`` one-hot over allele codes 0..4 (code 5 -> all-zero)."""
    alleles = jnp.arange(N_ALLELES, dtype=codes.dtype)
    return (codes[:, :, None] == alleles).astype(dtype)


def pair_tables(
    codes_a: jnp.ndarray,
    codes_b: jnp.ndarray,
    weights: jnp.ndarray,
    dtype=jnp.float32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted and unweighted joint allele tables for a tile pair.

    Args:
        codes_a: ``[N, T_a]`` int8 symbol codes (sequence-major slice).
        codes_b: ``[N, T_b]`` int8 symbol codes.
        weights: ``[N]`` per-sequence weights.
    Returns:
        ``(Jw, Ju)`` each ``[T_a, T_b, 5, 5]`` in ``dtype`` — see module doc.
    """
    oh_a = one_hot_alleles(codes_a, dtype)              # [N, Ta, 5]
    oh_b = one_hot_alleles(codes_b, dtype)              # [N, Tb, 5]
    oh_aw = oh_a * weights.astype(dtype)[:, None, None]
    # HIGHEST precision: the default matmul precision may run f32 operands
    # in TF32 on a GPU, which visibly corrupts the weighted sums; these
    # contractions must accumulate true f32.
    jw = jnp.einsum(
        "nas,nbt->abst", oh_aw, oh_b,
        preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST,
    )
    ju = jnp.einsum(
        "nas,nbt->abst", oh_a, oh_b,
        preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST,
    )
    return jw, ju


def major_dom_minor(cnt: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Major and dominant-minor allele codes from per-pair counts.

    Args:
        cnt: ``[..., 5]`` int32 allele counts.
    Returns:
        ``(major, dom_minor)`` int32 arrays shaped ``[...]``.  Ties pick the
        smallest code (the Rust reference's rule, ``lib.rs:126-140``, and
        the Python comment's intent; Python's actual unstable-argsort tie
        order is unspecified — see the module docstring).
    """
    code_bonus = (N_ALLELES - jnp.arange(N_ALLELES, dtype=jnp.int32))
    score = cnt * 8 + code_bonus
    major = jnp.argmax(score, axis=-1).astype(jnp.int32)
    masked = jnp.where(
        jnp.arange(N_ALLELES, dtype=jnp.int32) == major[..., None], -1, score
    )
    dom_minor = jnp.argmax(masked, axis=-1).astype(jnp.int32)
    return major, dom_minor


def _select2(jw: jnp.ndarray, sa: jnp.ndarray, tb: jnp.ndarray) -> jnp.ndarray:
    """``jw[a, b, sa[a,b], tb[a,b]]`` for ``jw`` shaped [Ta, Tb, 5, 5]."""
    row = jnp.take_along_axis(jw, sa[:, :, None, None], axis=2)[:, :, 0, :]
    return jnp.take_along_axis(row, tb[:, :, None], axis=2)[:, :, 0]


def finalize_pair_tile(jw: jnp.ndarray, ju: jnp.ndarray) -> PairStats:
    """Element-wise LD finalization over a pair tile (see module doc).

    Args:
        jw: ``[Ta, Tb, 5, 5]`` weighted joint tables.
        ju: ``[Ta, Tb, 5, 5]`` unweighted joint tables (float-valued counts).
    """
    cnt_a = jnp.round(ju.sum(axis=3)).astype(jnp.int32)     # [Ta, Tb, 5]
    cnt_b = jnp.round(ju.sum(axis=2)).astype(jnp.int32)

    distinct_a = (cnt_a > 0).sum(axis=-1)
    distinct_b = (cnt_b > 0).sum(axis=-1)
    keep = (distinct_a > 1) & (distinct_b > 1)              # WeightedLD.py:196-201

    maj_a, dmin_a = major_dom_minor(cnt_a)
    maj_b, dmin_b = major_dom_minor(cnt_b)

    # Second filtering pass (WeightedLD.py:217-225) collapses to selecting the
    # four {maj, domMinor} x {maj, domMinor} cells of the joint table.
    n_mm = _select2(jw, maj_a, maj_b)    # maj_a & maj_b   (ld_obs[3])
    n_md = _select2(jw, maj_a, dmin_b)   # maj_a & dmin_b  (ld_obs[2])
    n_dm = _select2(jw, dmin_a, maj_b)   # dmin_a & maj_b  (ld_obs[1])
    n_dd = _select2(jw, dmin_a, dmin_b)  # dmin_a & dmin_b (ld_obs[0])

    total_w = n_mm + n_md + n_dm + n_dd
    keep = keep & (total_w > 0)
    safe_w = jnp.where(total_w > 0, total_w, 1.0)

    pa_major = (n_mm + n_md) / safe_w    # PA (WeightedLD.py:228-229)
    pb_major = (n_mm + n_dm) / safe_w    # PB
    pa_minor = (n_dm + n_dd) / safe_w    # Pa (WeightedLD.py:230-231)
    pb_minor = (n_md + n_dd) / safe_w    # Pb

    # round(P, 1) == 1.0  <=>  P >= double(0.95) (WeightedLD.py:234-237).
    # PA is a np.float64 there, whose __round__ scales by 10 first:
    # double(0.95)*10 rounds to exactly 9.5 and half-evens UP, so the
    # exact-boundary pair (PA == 19/20) is SKIPPED by the reference —
    # unlike Python-float round(0.95, 1) == 0.9, which would keep it.
    keep = keep & (pa_major < 0.95) & (pb_major < 0.95)

    # Zero-major-weight pairs are skipped: when no second-filter survivor
    # carries the count-major allele at a site, the reference's PA (or PB)
    # is a fully-masked sum and ``round(PA, 1)`` raises TypeError
    # (WeightedLD.py:227-235 with np.ma) — it defines no output for such
    # pairs.  (The mirror case Pa == 0 implies PA == 1 and is already
    # caught by the 0.95 rule; pa_major == 0 also forces D == 0, so these
    # are exactly the would-be r2 = 0/0 = NaN pairs.)  With strictly
    # positive weights this test equals the unweighted-count test the
    # reference's crash condition is defined by.  Degenerate divergence:
    # a user-supplied weight of exactly 0.0 on a pair's only surviving
    # major carrier makes the reference print an r2 = 0/0 = NaN row (PA
    # is then an unmasked 0.0) where this engine skips — zero weights are
    # not a supported sequence-exclusion mechanism (the f64 audit engine
    # keeps the reference's NaN-row behaviour for that corner).
    keep = keep & (n_mm + n_md > 0) & (n_mm + n_dm > 0)

    obs_mm = n_mm / safe_w
    obs_md = n_md / safe_w
    obs_dm = n_dm / safe_w
    obs_dd = n_dd / safe_w

    # D = mean of the four equivalent estimates (WeightedLD.py:260-266).
    t0 = pa_major * pb_major - obs_mm
    t1 = pa_minor * pb_minor - obs_dd
    t2 = -(pa_major * pb_minor - obs_md)
    t3 = -(pa_minor * pb_major - obs_dm)
    d = (t0 + t1 + t2 + t3) * 0.25

    # D' denominator with zero-denominator fallback (WeightedLD.py:269-277).
    neg = jnp.maximum(-obs_dd, -obs_mm)
    neg = jnp.where(neg == 0, jnp.minimum(-obs_dd, -obs_mm), neg)
    pos = jnp.minimum(obs_dm, obs_md)
    pos = jnp.where(pos == 0, jnp.maximum(obs_dm, obs_md), pos)
    denom = jnp.where(d < 0, neg, pos)
    d_prime = d / denom                  # inf/nan on zero denom, as reference

    r2 = d * d / (pa_major * pa_minor * pb_major * pb_minor)

    return PairStats(d=d, d_prime=d_prime, r2=r2, keep=keep)


def ld_pair_tile(
    codes_a: jnp.ndarray,
    codes_b: jnp.ndarray,
    weights: jnp.ndarray,
    dtype=jnp.float32,
) -> PairStats:
    """Full LD statistics for every (site in A) x (site in B) pair."""
    jw, ju = pair_tables(codes_a, codes_b, weights, dtype)
    return finalize_pair_tile(jw, ju)
