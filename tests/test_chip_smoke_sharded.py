"""chip_smoke.py's sharded phase (e) on four virtual CPU devices: the
same comparisons the four-card run makes, at tiny size."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tests.make_synth_fasta import synth_fasta  # noqa: E402


def test_phase_sharded_tiny(tmp_path):
    big = synth_fasta(200_000, 10_000, 5, data_dir=str(tmp_path))
    spill = synth_fasta(50_000, 10_000, 6, data_dir=str(tmp_path))
    out = chip_smoke.phase_sharded(big, spill, n_devices=4,
                                   batch_per_shard=32, window=256, stack=2,
                                   n_sample=100)
    assert out["ok"], out
