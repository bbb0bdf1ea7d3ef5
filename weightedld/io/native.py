"""ctypes bindings to the native ingest library (``native/wldio.cpp``).

The reference keeps its data-loader in native code (the Rust FASTA reader,
``rust/weighted_ld/src/lib.rs:277-307``); this module plays that role here:
an mmap-based OpenMP C++ parser that writes FASTA/VCF files straight into the
int8 code matrices the device pipeline uploads.  Parsing semantics (and error
messages) are identical to the pure-Python readers in this package — those
remain the fallback when the shared library is absent and the oracle in
``tests/test_native_io.py``.

Set ``WLD_NATIVE_IO=0`` to force the Python path, or ``WLDIO_LIB`` to point
at a specific ``libwldio.so``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_ERR_CAP = 4096

_lib: ctypes.CDLL | None = None
_tried = False


def _candidates():
    env = os.environ.get("WLDIO_LIB")
    if env:
        yield Path(env)
    root = Path(__file__).resolve().parents[2]
    yield root / "native" / "libwldio.so"
    yield Path(__file__).resolve().parent / "libwldio.so"


def _configure(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(i64)
    lib.wldio_version.restype = ctypes.c_char_p
    lib.wldio_fasta_open.restype = ctypes.c_void_p
    lib.wldio_fasta_open.argtypes = [
        ctypes.c_char_p, p_i64, p_i64, p_i64, ctypes.c_char_p, i64,
    ]
    lib.wldio_fasta_fill.restype = ctypes.c_int
    lib.wldio_fasta_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
    ]
    lib.wldio_fasta_close.argtypes = [ctypes.c_void_p]
    lib.wldio_vcf_open.restype = ctypes.c_void_p
    lib.wldio_vcf_open.argtypes = [
        ctypes.c_char_p, p_i64, p_i64, ctypes.c_char_p, i64,
    ]
    lib.wldio_vcf_fill.restype = ctypes.c_int
    lib.wldio_vcf_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, i64,
    ]
    lib.wldio_vcf_close.argtypes = [ctypes.c_void_p]
    lib.wldio_format_pairs.restype = i64
    lib.wldio_format_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_void_p, i64,
    ]
    lib.wldio_format_weights.restype = i64
    lib.wldio_format_weights.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_void_p, i64,
    ]
    lib.wldio_transpose_pad_i8.restype = None
    lib.wldio_transpose_pad_i8.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64, i64, ctypes.c_int8,
    ]


def load() -> ctypes.CDLL | None:
    """Load the native library once; None if disabled or unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("WLD_NATIVE_IO", "1") == "0":
        return None
    explicit = os.environ.get("WLDIO_LIB")
    for path in _candidates():
        if not path.exists():
            if explicit and str(path) == explicit:
                _warn_bad_override(path, "not found")
            continue
        try:
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            version = lib.wldio_version()
            if version != b"wldio-4":
                if explicit and str(path) == explicit:
                    _warn_bad_override(path, f"version {version!r} != wldio-4")
                continue
        except (OSError, AttributeError) as e:
            if explicit and str(path) == explicit:
                _warn_bad_override(path, str(e))
            continue
        _lib = lib
        break
    return _lib


def _warn_bad_override(path, reason: str) -> None:
    import warnings

    warnings.warn(
        f"WLDIO_LIB={path} could not be used ({reason}); "
        "falling back to the next candidate / pure-Python io",
        RuntimeWarning,
        stacklevel=3,
    )


def available() -> bool:
    return load() is not None


def _check_readable(path) -> None:
    """Raise the same OSError subclass the pure-Python readers would
    (FileNotFoundError, IsADirectoryError, PermissionError, ...) instead of
    the native library's generic 'cannot open'."""
    with open(path, "rb"):
        pass


def read_fasta_native(path: str | Path) -> tuple[np.ndarray, list[str]]:
    """Native FASTA read: ``([n_seqs, n_sites] int8 codes, names)``.

    Raises ValueError with the same messages as the Python reader.
    """
    lib = load()
    assert lib is not None, "native io library not loaded"
    _check_readable(path)  # OSError subclasses, matching the Python reader
    n_seqs = ctypes.c_int64()
    n_sites = ctypes.c_int64()
    names_len = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    h = lib.wldio_fasta_open(
        str(path).encode(), ctypes.byref(n_seqs), ctypes.byref(n_sites),
        ctypes.byref(names_len), err, _ERR_CAP,
    )
    if not h:
        raise ValueError(err.value.decode("utf-8", "replace"))
    try:
        out = np.empty((n_seqs.value, n_sites.value), dtype=np.int8)
        names_buf = ctypes.create_string_buffer(max(1, names_len.value))
        lib.wldio_fasta_fill(
            h, out.ctypes.data_as(ctypes.c_void_p), names_buf,
        )
        raw = names_buf.raw[: names_len.value].decode("utf-8", "replace")
    finally:
        lib.wldio_fasta_close(h)
    if out.shape[1] == 0:
        # Header-only files: match the Python reader's ingest error instead
        # of returning an [N, 0] alignment (NaN weights downstream).
        raise ValueError(f"{path}: no sequences found")
    names = raw.split("\n") if raw else [""] * n_seqs.value
    if len(names) != n_seqs.value:  # all-empty names edge case
        names = (names + [""] * n_seqs.value)[: n_seqs.value]
    return out, names


def read_vcf_native(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Native VCF read: ``([n_haplotypes, n_sites] int8, POS int64)``.

    Applies the same rot90 row-reversal parity transform as the Python
    reader.  Raises ``VcfError`` with the same messages.
    """
    from .vcf import VcfError  # lazy: vcf.py imports this module

    lib = load()
    assert lib is not None, "native io library not loaded"
    _check_readable(path)  # OSError subclasses, matching the Python reader
    n_sites = ctypes.c_int64()
    n_haps = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    h = lib.wldio_vcf_open(
        str(path).encode(), ctypes.byref(n_sites), ctypes.byref(n_haps),
        err, _ERR_CAP,
    )
    if not h:
        raise VcfError(err.value.decode("utf-8", "replace"))
    try:
        mat = np.empty((n_sites.value, n_haps.value), dtype=np.int8)
        positions = np.empty(n_sites.value, dtype=np.int64)
        rc = lib.wldio_vcf_fill(
            h,
            mat.ctypes.data_as(ctypes.c_void_p),
            positions.ctypes.data_as(ctypes.c_void_p),
            err, _ERR_CAP,
        )
        if rc != 0:
            raise VcfError(err.value.decode("utf-8", "replace"))
    finally:
        lib.wldio_vcf_close(h)
    # rot90 parity: haplotype rows in reverse order (WeightedLD.py:375).
    alignment = np.ascontiguousarray(mat.T[::-1])
    return alignment, positions


def _c64(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def format_pairs_native(
    pos_a, pos_b, d, d_prime, r2, ndigits: int = 4
) -> str:
    """Format pair records as TSV rows, each cell ``repr(round(x, n))``
    (the Python reference's formatting, ``WeightedLD.py:282-284``)."""
    lib = load()
    assert lib is not None, "native io library not loaded"
    pa = np.ascontiguousarray(pos_a, dtype=np.int64)
    pb = np.ascontiguousarray(pos_b, dtype=np.int64)
    dd = np.ascontiguousarray(d, dtype=np.float64)
    dp = np.ascontiguousarray(d_prime, dtype=np.float64)
    rr = np.ascontiguousarray(r2, dtype=np.float64)
    n = len(pa)
    cap = 128 * n + 16
    buf = np.empty(cap, dtype=np.uint8)  # no zero-fill (ctypes buffers memset)
    written = lib.wldio_format_pairs(
        _c64(pa), _c64(pb), _c64(dd), _c64(dp), _c64(rr),
        n, ndigits, _c64(buf), cap,
    )
    if written < 0:
        raise ValueError(
            f"native pair formatting rejected the request (ndigits={ndigits})"
        )
    return buf[:written].tobytes().decode("ascii")


def format_weights_native(weights, ndigits: int = 6) -> str:
    """Format per-sequence weights as ``index\\tweight`` TSV rows."""
    lib = load()
    assert lib is not None, "native io library not loaded"
    w = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(w)
    cap = 64 * n + 16
    buf = np.empty(cap, dtype=np.uint8)
    written = lib.wldio_format_weights(_c64(w), n, ndigits, _c64(buf), cap)
    if written < 0:
        raise ValueError(
            f"native weights formatting rejected the request (ndigits={ndigits})"
        )
    return buf[:written].tobytes().decode("ascii")


def transpose_pad_i8(src: np.ndarray, s_pad: int, n_pad: int,
                     fill: int) -> np.ndarray:
    """``[N, S]`` int8 row-major -> ``[s_pad, n_pad]`` transposed + padded
    (the device upload layout) via the blocked OpenMP native kernel.
    Caller guarantees ``available()``; the numpy oracle lives in
    ``core.majmin.pad_alignment_site_major``."""
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int8)
    n, s = src.shape
    assert s_pad >= s and n_pad >= n
    dst = np.empty((s_pad, n_pad), dtype=np.int8)
    lib.wldio_transpose_pad_i8(
        _c64(src), ctypes.c_int64(n), ctypes.c_int64(s),
        _c64(dst), ctypes.c_int64(s_pad), ctypes.c_int64(n_pad),
        ctypes.c_int8(fill),
    )
    return dst
