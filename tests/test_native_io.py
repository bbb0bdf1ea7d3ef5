"""Native ingest (native/wldio.cpp) parity vs the pure-Python parsers.

The Python readers are the oracle; the native library must match them
byte-for-byte on outputs and reproduce the same error messages, across the
reference fixtures (SURVEY.md Appendix B), synthetic VCFs, adversarial
formats, and randomized property inputs.
"""

import string
import subprocess
from pathlib import Path

import numpy as np
import pytest

from weightedld.io import native
from weightedld.io.fasta import (
    read_fasta_with_names,
    read_fasta_with_names_python,
)
from weightedld.io.vcf import VcfError, read_vcf_python

from .fixtures import ALL_FASTAS, T7_PATH, write_fasta

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"


def _ensure_lib():
    so = NATIVE_DIR / "libwldio.so"
    src = NATIVE_DIR / "wldio.cpp"
    stale = (
        not so.exists()
        or (src.exists() and src.stat().st_mtime > so.stat().st_mtime)
    )
    if stale:  # rebuild so a committed .so never shadows edited source
        try:
            subprocess.run(
                ["make", "-C", str(NATIVE_DIR), "-B", "libwldio.so"],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            pass
    return native.available()


pytestmark = pytest.mark.skipif(
    not _ensure_lib(), reason="native io library unavailable"
)


# ---------------------------------------------------------------------------
# FASTA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL_FASTAS))
def test_fasta_fixture_parity(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    aln_n, names_n = native.read_fasta_native(path)
    aln_p, names_p = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    assert names_n == names_p
    assert aln_n.dtype == np.int8


def test_fasta_multiline_and_names(tmp_path):
    path = tmp_path / "wrapped.fasta"
    path.write_text(
        ">alpha desc here\nAC\nGT\n\n>beta\n  acgt  \n> gamma\nNN-n\n"
    )
    aln_n, names_n = native.read_fasta_native(path)
    aln_p, names_p = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    assert names_n == names_p == ["alpha desc here", "beta", "gamma"]


def test_fasta_crlf(tmp_path):
    path = tmp_path / "crlf.fasta"
    path.write_bytes(b">a\r\nACGT\r\n>b\r\nTGCA\r\n")
    aln_n, names_n = native.read_fasta_native(path)
    aln_p, names_p = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    assert names_n == names_p


def test_fasta_no_trailing_newline(tmp_path):
    path = tmp_path / "x.fasta"
    path.write_text(">a\nACGT\n>b\nTTTT")
    aln_n, _ = native.read_fasta_native(path)
    aln_p, _ = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)


@pytest.mark.parametrize(
    "content,match",
    [
        (">a\nACG\n>b\nAC\n", "ragged"),
        ("ACGT\n>a\nACGT\n", "before first '>' header"),
        ("\n\n", "no sequences found"),
    ],
)
def test_fasta_errors_match(tmp_path, content, match):
    path = tmp_path / "bad.fasta"
    path.write_text(content)
    with pytest.raises(ValueError, match=match) as e_native:
        native.read_fasta_native(path)
    with pytest.raises(ValueError, match=match) as e_python:
        read_fasta_with_names_python(path)
    assert str(e_native.value) == str(e_python.value)


def test_fasta_random_property(tmp_path):
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(
        (string.ascii_letters + "-.*NRYKM ").encode(), dtype=np.uint8
    )
    # 40 seqs x 500 sites, wrapped at odd widths, random junk characters.
    rows = alphabet[rng.integers(0, len(alphabet) - 1, size=(40, 500))]
    path = tmp_path / "rand.fasta"
    with open(path, "w") as fh:
        for i, row in enumerate(rows):
            s = row.tobytes().decode()
            fh.write(f">r{i} extra stuff\n")
            for j in range(0, len(s), 73):
                fh.write(s[j : j + 73] + "\n")
    aln_n, names_n = native.read_fasta_native(path)
    aln_p, names_p = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    assert names_n == names_p


def test_fasta_dispatch_uses_native(tmp_path):
    # The public reader should route to the native path when available.
    path = tmp_path / "d.fasta"
    write_fasta(path, ALL_FASTAS["example"])
    aln, names = read_fasta_with_names(path)
    aln_p, names_p = read_fasta_with_names_python(path)
    np.testing.assert_array_equal(aln, aln_p)
    assert names == names_p


# ---------------------------------------------------------------------------
# VCF
# ---------------------------------------------------------------------------

SAMPLES = 16
HEADER = (
    "##fileformat=VCFv4.1\n"
    "##contig=<ID=1>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
    + "\t".join(f"s{i}" for i in range(SAMPLES))
)


def _mk_vcf(tmp_path, rows, name="x.vcf"):
    path = tmp_path / name
    path.write_text(HEADER + "\n" + "\n".join(rows) + "\n")
    return path


def _row(pos, gts):
    return f"1\t{pos}\trs{pos}\tA\tT\t100\tPASS\t.\tGT\t" + "\t".join(gts)


def _assert_vcf_parity(path):
    aln_n, pos_n = native.read_vcf_native(path)
    aln_p, pos_p = read_vcf_python(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    np.testing.assert_array_equal(pos_n, pos_p)
    assert aln_n.dtype == np.int8 and pos_n.dtype == np.int64


def test_vcf_basic_phased(tmp_path):
    gts = ["0|1"] * 8 + ["1|1"] * 4 + ["0|0"] * 4
    _assert_vcf_parity(
        _mk_vcf(tmp_path, [_row(1000, gts), _row(2000, list(reversed(gts)))])
    )


def test_vcf_mixed_forms(tmp_path):
    # Unphased, half-calls, FORMAT subfields, haploid, missing-only.
    gts = (
        ["0/1", ".|1", "1|.", "0|1:35:99", "1", ".", "0|0", "1|1"]
        + ["0|1"] * 8
    )
    _assert_vcf_parity(_mk_vcf(tmp_path, [_row(5, gts), _row(9, gts)]))


def test_vcf_large_positions(tmp_path):
    gts = ["0|1"] * SAMPLES
    _assert_vcf_parity(_mk_vcf(tmp_path, [_row(44890030, gts)]))


def test_vcf_alt_codes(tmp_path):
    gts = ["0|2", "3|1", "4|5", "2|2"] + ["0|0"] * (SAMPLES - 4)
    _assert_vcf_parity(_mk_vcf(tmp_path, [_row(7, gts)]))


@pytest.mark.skipif(
    not Path(T7_PATH).exists(), reason="reference fixture absent"
)
def test_vcf_t7_parity():
    _assert_vcf_parity(T7_PATH)


def test_vcf_errors_match(tmp_path):
    cases = []
    p = tmp_path / "nohdr.vcf"
    p.write_text("1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n")
    cases.append((p, "#CHROM"))
    p = tmp_path / "small.vcf"
    p.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\n"
        "1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n"
    )
    cases.append((p, "multi-sample"))
    cases.append(
        (
            _mk_vcf(
                tmp_path,
                [_row(5, ["0|6"] + ["0|1"] * (SAMPLES - 1))],
                "alt6.vcf",
            ),
            "allele index 6",
        )
    )
    cases.append(
        (
            _mk_vcf(
                tmp_path,
                [
                    _row(5, ["0|1"] * SAMPLES),
                    _row(6, ["0|1"] * (SAMPLES - 1)),
                ],
                "ragged.vcf",
            ),
            "inconsistent haplotype count",
        )
    )
    for path, match in cases:
        with pytest.raises(VcfError, match=match):
            native.read_vcf_native(path)
        with pytest.raises(VcfError, match=match):
            read_vcf_python(path)


# ---------------------------------------------------------------------------
# Differential fuzz: native and Python must agree on accept/reject AND output
# ---------------------------------------------------------------------------

def _mutate(rng, text: str) -> str:
    b = bytearray(text.encode())
    for _ in range(rng.integers(1, 4)):
        if not b:
            break
        op = rng.integers(0, 4)
        i = int(rng.integers(0, len(b)))
        if op == 0:
            b[i] = int(rng.integers(32, 127))
        elif op == 1:
            del b[i : i + int(rng.integers(1, 6))]
        elif op == 2:
            b[i:i] = bytes([int(rng.integers(32, 127))]) * int(
                rng.integers(1, 6)
            )
        else:
            b = b[:i]
    return b.decode("latin-1")


def test_differential_fuzz_fasta(tmp_path):
    rng = np.random.default_rng(99)
    base = ">a\nACGT\n>b\nTG-n\n>c wide\nAC\nGT\n"
    for i in range(150):
        text = _mutate(rng, base)
        path = tmp_path / "f.fasta"
        path.write_text(text)
        try:
            want = read_fasta_with_names_python(path)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native.read_fasta_native(path)
            assert str(got.value) == str(e), text
            continue
        aln, names = native.read_fasta_native(path)
        np.testing.assert_array_equal(aln, want[0], err_msg=repr(text))
        assert names == want[1], repr(text)


def test_differential_fuzz_vcf(tmp_path):
    rng = np.random.default_rng(7)
    base = (
        HEADER + "\n"
        + _row(5, ["0|1", ".|.", "1|1", "0/1"] * 4) + "\n"
        + _row(9, ["0|0", "1|.", "2|3", "."] * 4) + "\n"
    )
    for i in range(150):
        text = _mutate(rng, base)
        path = tmp_path / "f.vcf"
        path.write_text(text)
        try:
            want = read_vcf_python(path)
        except (ValueError, OverflowError) as e:
            with pytest.raises((ValueError, OverflowError)):
                native.read_vcf_native(path)
            continue
        aln, pos = native.read_vcf_native(path)
        np.testing.assert_array_equal(aln, want[0], err_msg=repr(text))
        np.testing.assert_array_equal(pos, want[1], err_msg=repr(text))


# ---------------------------------------------------------------------------
# gzip-compressed inputs (.fasta.gz / .vcf.gz)
# ---------------------------------------------------------------------------

def test_gzip_fasta_both_backends(tmp_path):
    import gzip

    plain = tmp_path / "x.fasta"
    write_fasta(plain, ALL_FASTAS["example"])
    gz = tmp_path / "x.fasta.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    want, want_names = read_fasta_with_names_python(plain)
    for reader in (native.read_fasta_native, read_fasta_with_names_python):
        aln, names = reader(gz)
        np.testing.assert_array_equal(aln, want)
        assert names == want_names


def test_gzip_vcf_both_backends_and_dispatch(tmp_path):
    import gzip

    import weightedld as wld

    gts = ["0|1"] * 8 + ["1|1"] * 4 + ["0|0"] * 4
    plain = _mk_vcf(tmp_path, [_row(1000, gts), _row(2000, gts)])
    gz = tmp_path / "x.vcf.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    want, want_pos = read_vcf_python(plain)
    for reader in (native.read_vcf_native, read_vcf_python):
        aln, pos = reader(gz)
        np.testing.assert_array_equal(aln, want)
        np.testing.assert_array_equal(pos, want_pos)
    # Suffix dispatch: .vcf.gz must take the VCF path end-to-end.
    res = wld.prepare(gz)
    assert res.alignment.shape == want.shape
    assert res.site_map.tolist() == want_pos.tolist()


def test_gzip_multimember_bgzf_style(tmp_path):
    # bgzip/bcftools .vcf.gz files are CONCATENATED gzip members; both
    # backends must inflate all members, not silently stop at the first.
    import gzip

    half1 = ">a\nACGT\n"
    half2 = ">b\nTGCA\n"
    gz = tmp_path / "multi.fasta.gz"
    gz.write_bytes(gzip.compress(half1.encode()) + gzip.compress(half2.encode()))
    for reader in (native.read_fasta_native, read_fasta_with_names_python):
        aln, names = reader(gz)
        assert names == ["a", "b"]
        assert aln.shape == (2, 4)


def test_gzip_trailing_garbage_rejected(tmp_path):
    import gzip

    gz = tmp_path / "garbage.fasta.gz"
    gz.write_bytes(gzip.compress(b">a\nACGT\n") + b"NOT GZIP DATA")
    with pytest.raises(ValueError, match="trailing garbage"):
        native.read_fasta_native(gz)
    with pytest.raises(Exception):  # gzip.BadGzipFile (OSError subclass)
        read_fasta_with_names_python(gz)


def test_missing_file_raises_oserror(tmp_path):
    from weightedld.io.fasta import read_fasta_with_names
    from weightedld.io.vcf import read_vcf

    with pytest.raises(FileNotFoundError):
        read_fasta_with_names(tmp_path / "nope.fasta")
    with pytest.raises(FileNotFoundError):
        read_vcf(tmp_path / "nope.vcf")
    with pytest.raises(IsADirectoryError):
        read_fasta_with_names(tmp_path)


def test_vcf_pos_underscore_separators(tmp_path):
    # CPython int() accepts digit-group underscores; both backends must.
    gts = ["0|1"] * SAMPLES
    path = _mk_vcf(tmp_path, [_row("1_000", gts)])
    for reader in (native.read_vcf_native, read_vcf_python):
        _, pos = reader(path)
        assert pos.tolist() == [1000]
    bad = _mk_vcf(tmp_path, [_row("1__0", gts)], "bad_us.vcf")
    for reader in (native.read_vcf_native, read_vcf_python):
        with pytest.raises(ValueError, match="invalid literal"):
            reader(bad)


def test_fasta_unicode_whitespace_name_trim(tmp_path):
    # Python strips names AFTER decoding, so Unicode whitespace (NBSP,
    # ideographic space) must come off in the native reader too.
    path = tmp_path / "u.fasta"
    path.write_bytes(
        b">foo\xc2\xa0\nAC\n>\xe3\x80\x80bar baz\xe2\x80\x89\nGT\n"
    )
    for reader in (native.read_fasta_native, read_fasta_with_names_python):
        _, names = reader(path)
        assert names == ["foo", "bar baz"], reader


def test_gzip_truncated_rejected(tmp_path):
    import gzip

    plain = tmp_path / "x.fasta"
    write_fasta(plain, ALL_FASTAS["example"])
    blob = gzip.compress(plain.read_bytes())
    bad = tmp_path / "trunc.fasta.gz"
    bad.write_bytes(blob[: len(blob) // 2])
    with pytest.raises((ValueError, EOFError)):
        native.read_fasta_native(bad)
    with pytest.raises((ValueError, EOFError)):
        read_fasta_with_names_python(bad)


# ---------------------------------------------------------------------------
# TSV formatting (repr(round(x, n)) parity)
# ---------------------------------------------------------------------------

ADVERSARIAL_FLOATS = [
    0.0, -0.0, 1.0, -1.0, 0.5, -0.25, 0.03125, -0.03125,
    0.00005, -0.00005, 0.00048828125, 1e-05, 9.999e-05, 0.0001, 0.00012,
    1e16, 1e17, 9999999999999998.0, 0.1, 0.10285,
    float("nan"), float("inf"), float("-inf"), 1e-300, -1e-300, 1e300,
    0.99995, -0.99995, 0.099995, 2.5e-05, 7.5e-05, 0.12345,
    0.123450000001, 1.00005, 123456.00005, 123456789012345.6789,
    0.9999999999999999, 0.49995, 0.999999, 9.9999e-05,
]


def _format_vals():
    rng = np.random.default_rng(3)
    return np.concatenate([
        np.array(ADVERSARIAL_FLOATS),
        rng.uniform(-1, 1, 20000),
        rng.uniform(-1, 1, 5000).astype(np.float32).astype(np.float64),
        np.round(rng.uniform(-1, 1, 5000), 4),
        rng.uniform(-1e-4, 1e-4, 5000),
        rng.integers(-9, 9, 5000).astype(np.float64) / 32,       # dyadic ties
        rng.integers(-99999, 99999, 5000).astype(np.float64) / 2e4,  # .5 ties
    ])


@pytest.mark.parametrize("ndigits", [4, 3, 6, 0])
def test_format_pairs_repr_round_parity(ndigits):
    vals = _format_vals()
    n = len(vals)
    zeros = np.zeros(n, np.int64)
    out = native.format_pairs_native(zeros, zeros, vals, vals, vals, ndigits)
    rows = out.rstrip("\n").split("\n")
    assert len(rows) == n
    for v, row in zip(vals, rows):
        want = repr(round(float(v), ndigits))
        cells = row.split("\t")
        assert cells[2] == cells[3] == cells[4] == want, (v, cells, want)


def test_write_pairs_native_matches_python(monkeypatch):
    import io

    from weightedld.core.ld_dense import LdRecords
    from weightedld.io.writer import write_pairs

    rng = np.random.default_rng(5)
    n = 5000
    rec = LdRecords(
        pos_a=rng.integers(0, 10**9, n).astype(np.int64),
        pos_b=rng.integers(0, 10**9, n).astype(np.int64),
        d=rng.uniform(-0.25, 0.25, n),
        d_prime=rng.uniform(0, 1, n),
        r2=rng.uniform(0, 1, n),
    )
    b_native = io.StringIO()
    write_pairs(rec, b_native)
    monkeypatch.setattr(native, "available", lambda: False)
    b_python = io.StringIO()
    write_pairs(rec, b_python)
    assert b_native.getvalue() == b_python.getvalue()


def test_write_weights_native_matches_python(monkeypatch):
    import io

    from weightedld.io.writer import write_weights

    rng = np.random.default_rng(6)
    w = np.concatenate([rng.uniform(0, 1, 2000), [1.0, 0.0, 0.5, 1e-5]])
    b_native = io.StringIO()
    write_weights(w, b_native)
    monkeypatch.setattr(native, "available", lambda: False)
    b_python = io.StringIO()
    write_weights(w, b_python)
    assert b_native.getvalue() == b_python.getvalue()


def test_vcf_crlf_and_cr_line_endings(tmp_path):
    # Python reads VCFs in text mode (universal newlines); the native
    # scanner must treat \r\n and lone \r as terminators too.
    gts = ["0|1"] * SAMPLES
    text = HEADER + "\n" + _row(5, gts) + "\n" + _row(9, gts) + "\n"
    for name, nl in [("crlf.vcf", "\r\n"), ("cr.vcf", "\r")]:
        path = tmp_path / name
        path.write_bytes(text.replace("\n", nl).encode())
        _assert_vcf_parity(path)


def test_vcf_error_messages_identical(tmp_path):
    # Message parity, not just type parity: bad allele tokens, bad POS,
    # inconsistent haplotype counts (full count, not clamped).
    cases = [
        _mk_vcf(tmp_path, [_row(5, ["0x|1"] + ["0|1"] * (SAMPLES - 1))],
                "badtok.vcf"),
        _mk_vcf(tmp_path, [_row("abc", ["0|1"] * SAMPLES)], "badpos.vcf"),
        _mk_vcf(
            tmp_path,
            [_row(5, ["0|1"] * SAMPLES), _row(6, ["0|1"] * (SAMPLES + 2))],
            "overcount.vcf",
        ),
        _mk_vcf(
            tmp_path,
            [_row(5, ["0|1"] * SAMPLES), _row(6, ["0|1"] * (SAMPLES - 1))],
            "undercount.vcf",
        ),
    ]
    for path in cases:
        with pytest.raises(ValueError) as e_native:
            native.read_vcf_native(path)
        with pytest.raises(ValueError) as e_python:
            read_vcf_python(path)
        assert str(e_native.value) == str(e_python.value), path.name


def test_format_negative_ndigits_uses_python_path():
    # round(x, -1) rounds to tens; %.*f cannot express that, so the writer
    # must route negative ndigits to the Python formatter.
    import io

    from weightedld.core.ld_dense import LdRecords
    from weightedld.io.writer import write_pairs

    rec = LdRecords(
        pos_a=np.array([0], np.int64), pos_b=np.array([1], np.int64),
        d=np.array([14.0]), d_prime=np.array([15.0]), r2=np.array([1.0]),
    )
    b = io.StringIO()
    write_pairs(rec, b, ndigits=-1)
    assert b.getvalue().splitlines()[1] == "0\t1\t10.0\t20.0\t0.0"


def test_vcf_random_property(tmp_path):
    rng = np.random.default_rng(11)
    forms = np.array(
        ["0|0", "0|1", "1|0", "1|1", "0/1", ".|.", ".|0", "1|.",
         "0|1:12", "2|3"]
    )
    rows = []
    pos = 100
    for _ in range(50):
        pos += int(rng.integers(1, 1000))
        gts = forms[rng.integers(0, len(forms), size=SAMPLES)]
        rows.append(_row(pos, list(gts)))
    _assert_vcf_parity(_mk_vcf(tmp_path, rows, "rand.vcf"))


def test_formatter_locale_independent():
    # The TSV formatter must not honor LC_NUMERIC: a host process with a
    # comma-decimal locale previously corrupted slow-path values
    # (snprintf/strtod are locale-sensitive; std::to_chars is not).
    import ctypes
    import ctypes.util

    from weightedld.io import native

    if not native.available():
        pytest.skip("native library not built")
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.setlocale.restype = ctypes.c_char_p
    LC_NUMERIC = 1
    old = libc.setlocale(LC_NUMERIC, None)
    if libc.setlocale(LC_NUMERIC, b"de_DE.UTF-8") is None and \
            libc.setlocale(LC_NUMERIC, b"fr_FR.UTF-8") is None:
        pytest.skip("no comma-decimal locale installed")
    try:
        vals = np.array([2.67485, 0.5, 1e-5, 123.450000049], dtype=np.float64)
        rows = native.format_pairs_native(
            np.zeros(4, np.int64), np.ones(4, np.int64),
            vals, vals, vals, ndigits=4,
        )
        text = rows if isinstance(rows, str) else rows.decode()
        assert "," not in text, text
        for v in vals:
            assert repr(round(float(v), 4)) in text
    finally:
        libc.setlocale(LC_NUMERIC, old)


def test_transpose_pad_parity_and_size_gate():
    # The native blocked transpose must be bit-identical to the numpy
    # oracle, including both padding regions and awkward (non-multiple)
    # shapes that straddle the 128-block boundaries.
    from weightedld.io import native
    from weightedld.core.majmin import pad_alignment_site_major

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(5)
    for n, s, tile, chunk in [(3, 5, 8, 16), (130, 257, 64, 128),
                              (200, 129, 128, 256), (128, 128, 128, 128)]:
        aln = rng.integers(0, 6, size=(n, s), dtype=np.int8)
        s_pad = -(-s // tile) * tile
        n_pad = -(-n // chunk) * chunk
        got = native.transpose_pad_i8(aln, s_pad, n_pad, 5)
        oracle = np.full((s_pad, n_pad), 5, dtype=np.int8)
        oracle[:s, :n] = aln.T
        np.testing.assert_array_equal(got, oracle)
        # The public entry point agrees with itself regardless of route
        # (the size gate picks numpy here).
        np.testing.assert_array_equal(
            pad_alignment_site_major(aln, tile, chunk), oracle)
