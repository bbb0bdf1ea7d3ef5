"""FASTA reading and symbol encoding parity tests (ref test.py:13-17)."""

import numpy as np
import pytest

from weightedld.core.encode import encode_alignment
from weightedld.io.fasta import read_fasta, read_fasta_with_names

from .fixtures import ALL_FASTAS, EXAMPLE, write_fasta


def test_t1_checksum(tmp_path):
    # The reference's encoding checksum: t1 sums to 65 (test.py:13-17).
    path = tmp_path / "t1.fasta"
    write_fasta(path, ALL_FASTAS["t1"])
    aln = read_fasta(path)
    assert aln.shape == (5, 7)
    assert int(aln.sum()) == 65


def test_example_shape_and_sum(tmp_path):
    path = tmp_path / "example.fasta"
    write_fasta(path, EXAMPLE)
    aln = read_fasta(path)
    assert aln.shape == (10, 4)
    assert int(aln.sum()) == 54  # verified against the reference encoder


def test_encoding_table():
    aln = encode_alignment([b"acgt-nACGT"])
    assert aln.tolist() == [[0, 1, 2, 3, 4, 5, 0, 1, 2, 3]]


def test_multiline_records(tmp_path):
    # BioPython concatenates wrapped lines (WeightedLD.py:25); so do we.
    path = tmp_path / "wrapped.fasta"
    path.write_text(">s1\nAC\nGT\n>s2\nACGT\n")
    aln = read_fasta(path)
    assert aln.shape == (2, 4)
    assert (aln[0] == aln[1]).all()


def test_names(tmp_path):
    path = tmp_path / "n.fasta"
    path.write_text(">alpha desc\nAC\n>beta\nGT\n")
    aln, names = read_fasta_with_names(path)
    assert names == ["alpha desc", "beta"]
    assert aln.shape == (2, 2)


def test_ragged_rejected(tmp_path):
    path = tmp_path / "bad.fasta"
    path.write_text(">a\nACG\n>b\nAC\n")
    with pytest.raises(ValueError, match="ragged"):
        read_fasta(path)


@pytest.mark.parametrize("name", sorted(ALL_FASTAS))
def test_fixture_shapes(tmp_path, name):
    seqs = ALL_FASTAS[name]
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, seqs)
    aln = read_fasta(path)
    assert aln.shape == (len(seqs), len(seqs[0]))
    assert aln.dtype == np.int8


def test_header_only_fasta_rejected(tmp_path):
    # Header-only files must be a clean ingest error on BOTH io paths, not
    # an [N, 0] alignment (NaN weights downstream).
    import pytest

    from weightedld.io.fasta import (
        read_fasta_with_names,
        read_fasta_with_names_python,
    )

    f = tmp_path / "hdr.fasta"
    f.write_text(">seq1\n>seq2\n")
    for fn in (read_fasta_with_names, read_fasta_with_names_python):
        with pytest.raises(ValueError, match="no sequences found"):
            fn(f)


def test_gzip_open_does_not_leak_fd(tmp_path):
    import gzip

    from weightedld.io.fasta import _open_maybe_gzip

    f = tmp_path / "x.fasta.gz"
    with gzip.open(f, "wt") as g:
        g.write(">a\nACGT\n")
    h = _open_maybe_gzip(f)
    raw = getattr(h, "fileobj", None) or getattr(h, "myfileobj", None)
    h.close()
    # gzip.open(path) owns its underlying file and closes it with the
    # GzipFile (a caller-supplied handle would be left open).
    assert raw is None or raw.closed


# ---------------------------------------------------------------------------
# The Rust binary's line-based FASTA reader (lib.rs:277-307), --compat rust
# ---------------------------------------------------------------------------


def test_rust_reader_unwrapped_adds_newline_column(tmp_path):
    """On unwrapped FASTA the rust reader equals the python reader plus ONE
    trailing Unknown column (the kept '\\n') — monomorphic, masked out
    downstream, so CLI outputs match."""
    from weightedld.io.fasta import read_fasta, read_fasta_rust

    f = tmp_path / "x.fasta"
    f.write_text(">a\nACGT-\n>b\nacgta\n")
    py = read_fasta(f)
    ru = read_fasta_rust(f)
    assert ru.shape == (py.shape[0], py.shape[1] + 1)
    np.testing.assert_array_equal(ru[:, :-1], py)
    assert (ru[:, -1] == 5).all()  # '\n' -> Unknown


def test_rust_reader_wrapped_records_are_separate_rows(tmp_path):
    """Wrapped records are NOT concatenated: equal-length wraps become
    separate sequences (so N doubles), unequal wraps abort."""
    from weightedld.io.fasta import read_fasta_rust

    f = tmp_path / "wrapped.fasta"
    f.write_text(">a\nACGT\nTGCA\n>b\nAAAA\nCCCC\n")
    ru = read_fasta_rust(f)
    assert ru.shape == (4, 5)  # every wrap line its own row (+'\n' col)

    g = tmp_path / "ragged.fasta"
    g.write_text(">a\nACGT\nTG\n")
    with pytest.raises(ValueError, match="does not concatenate"):
        read_fasta_rust(g)


def test_rust_reader_missing_trailing_newline_is_ragged(tmp_path):
    from weightedld.io.fasta import read_fasta_rust

    f = tmp_path / "x.fasta"
    f.write_text(">a\nACGT\n>b\nTGCA")  # last line: no '\n' -> 4 vs 5 syms
    with pytest.raises(ValueError, match="expected 5"):
        read_fasta_rust(f)


def test_compat_rust_selects_rust_reader(tmp_path, capsys):
    """--compat rust flips the FASTA reader; on a WRAPPED file the run must
    abort like the binary would (exit 2), while --fasta-reader python on
    the same file succeeds."""
    from weightedld.cli import main

    f = tmp_path / "wrapped.fasta"
    f.write_text(">a\nACGTACGT\nAC\n>b\nTTTTACGT\nGT\n"
                 ">c\nACGTACGT\nAC\n>d\nACTTACGT\nGT\n")
    rc = main(["--file", str(f), "--compat", "rust"])
    assert rc == 2
    assert "does not concatenate" in capsys.readouterr().err
    rc = main(["--file", str(f), "--compat", "rust",
               "--fasta-reader", "python"])
    capsys.readouterr()
    assert rc == 0
