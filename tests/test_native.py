"""Native C++ FASTA parser vs the Python oracle reader."""
import os

import numpy as np
import pytest

from brisk_tpu import native
from brisk_tpu.io.fasta import chunk_codes
from brisk_tpu.oracle import pyref


@pytest.fixture(scope="module")
def lib():
    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    return native.load()


@pytest.mark.parametrize("path", ["data/test.fa", "data/debug_test.fa"])
def test_fixture_parity(lib, path):
    got = native.parse_fasta_codes(path)
    exp = [chunk_codes(c) for c in pyref.read_fasta_chunks(path)]
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g, e)


def test_messy_fasta(lib, tmp_path):
    p = tmp_path / "messy.fa"
    p.write_text(
        ">r1 header with > inside\n"
        "ACGTacgtNNNNacgt\n"
        "NNNN\nGGGG\n"
        ">r2\n"
        "\n"
        "A>CGT\n"     # '>' mid-line is an invalid char, not a header
        ">r3\nTTTT")  # no trailing newline
    got = native.parse_fasta_codes(str(p))
    exp = [chunk_codes(c) for c in pyref.read_fasta_chunks(str(p))]
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g, e)


def test_gzip(lib, tmp_path):
    import gzip
    p = tmp_path / "z.fa.gz"
    with gzip.open(p, "wt") as f:
        f.write(">x\nACGTACGTNACGT\n>y\nTTTT\n")
    got = native.parse_fasta_codes(str(p))
    exp = [chunk_codes(c) for c in pyref.read_fasta_chunks(str(p))]
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g, e)


def test_empty_and_missing(lib, tmp_path):
    p = tmp_path / "empty.fa"
    p.write_text("")
    assert native.parse_fasta_codes(str(p)) == []
    with pytest.raises(IOError):
        native.parse_fasta_codes(str(tmp_path / "nope.fa"))


def test_build_lands_in_checkout_without_march_native():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = native.build_command("out.so")
    assert not any(a.startswith(("-march", "-mtune", "-mcpu")) for a in cmd)
    assert os.path.commonpath([native.SO_PATH, root]) == root
    top = os.path.relpath(native.SO_PATH, root).split(os.sep)[0]
    with open(os.path.join(root, ".gitignore")) as f:
        assert f"{top}/" in f.read().split()
    assert native.load() is not None and os.path.exists(native.SO_PATH)


def test_build_failure_reported_once(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "lib.so"))
    missing = str(tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "build_command",
                        lambda out: ["g++", missing, "-o", out])
    assert native.load() is None
    assert native.load() is None
    assert native.parse_fasta_codes("data/test.fa") is None
    err = capsys.readouterr().err
    assert err.count("pure-Python FASTA parser") == 1
    assert "missing.cpp" in err  # the compiler's own message
    assert not os.listdir(tmp_path)  # no half-written library left
