"""chip_smoke.py on the CPU: each phase at tiny size, its float64
decycling reference against the oracle, and its refusal to run (printing
no result) without a GPU or outside the repository."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from brisk_tpu.oracle import pyref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tests.make_synth_fasta import synth_fasta  # noqa: E402


@pytest.fixture(scope="module")
def synth_200kb(tmp_path_factory):
    d = tmp_path_factory.mktemp("smoke")
    return synth_fasta(200_000, 10_000, 5, data_dir=str(d))


@pytest.mark.parametrize("cfg", [(31, 11, 8), (31, 15, 14)])
def test_phase_kernels_tiny(cfg):
    out = chip_smoke.phase_kernels(R=2048, configs=(cfg,), m_dec=5, reps=1)
    assert out["ok"], out
    assert out["decycling_mismatches"] == 0
    assert sum(key.startswith("finalize_") for key in out) == 1


@pytest.mark.parametrize("m", [5, 6, 7])
def test_decycling_f64_reference_matches_oracle(m):
    vals = np.arange(1 << (2 * m), dtype=np.uint64)
    dede = pyref.DecyclingSet(m)
    want = [dede.mem_double(int(v)) for v in vals]
    assert chip_smoke.decycling_classes_f64(vals, m).tolist() == want


@pytest.mark.parametrize("cfg", [(31, 15, 14), (63, 21, 14)])
def test_phase_cli_tiny(cfg):
    out = chip_smoke.phase_cli("data/test.fa", configs=(cfg,),
                               extra_args=("--batch", "16",
                                           "--window", "128"))
    assert out["ok"], out


def test_phase_real_tiny(synth_200kb):
    out = chip_smoke.phase_real(synth_200kb, batch=64, window=256, stack=2,
                                n_sample_records=2, n_absent=1000)
    assert out["ok"], out
    assert out["n_emitted"] == 198_780


def test_n_kmers_expected_matches_oracle(tmp_path):
    p = tmp_path / "mixed.fa"
    p.write_text(">a\nACGTACGTNNACGTACGTAC\nacgtacgtACGT\n>b\nACG\n"
                 ">c\nTTTTTTTTTTGGGGGGGGGGCCCCC\n")
    for k in (3, 5, 11):
        want = sum(max(len(c) - k + 1, 0)
                   for c in pyref.read_fasta_chunks(str(p)))
        assert chip_smoke.n_kmers_expected(str(p), k) == want


@pytest.mark.parametrize("argv", [[], ["--phase", "b", "--phase", "d"],
                                  ["--chips", "4"]])
def test_main_refuses_cpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_script_fails_without_gpu(where, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    # inside the repo it refuses the CPU; alone it cannot import the package
    assert ("needs a GPU" if where == "repo" else "brisk_tpu") in r.stderr
