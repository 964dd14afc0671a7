"""ShardedBrisk facade on an 8-device CPU mesh: end-to-end file counting,
lookup, skew spill, and sharded checkpoint round-trip vs the oracle."""
import random

import numpy as np
import pytest

from brisk_tpu.oracle import pyref
from brisk_tpu.params import Parameters
from brisk_tpu.parallel import sharded
from brisk_tpu.parallel.facade import ShardedBrisk

random.seed(23)


def rand_seq(n):
    return "".join(random.choice("ACGT") for _ in range(n))


def write_fa(path, records):
    with open(path, "w") as f:
        for i, seq in enumerate(records):
            f.write(f">r{i}\n{seq}\n")


@pytest.fixture(scope="module")
def mesh():
    return sharded.make_mesh(8)


def test_facade_insert_file_count_parity(tmp_path, mesh):
    """One long chromosome + short reads: windowing spreads the long
    record across all shards' lanes; counts match the oracle exactly."""
    k, m, b = 31, 11, 8
    records = [rand_seq(4000)] + [rand_seq(random.randint(k, 200))
                                  for _ in range(20)]
    path = str(tmp_path / "in.fa")
    write_fa(path, records)

    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=8, window=64, stack=2,
                      capacity=1 << 15)
    br.insert_file(path)

    exp = pyref.count_fasta(path, k, m)
    assert br.counts_dict() == exp
    assert br.n_emitted == sum(len(s) - k + 1 for s in records)

    # point lookups through the sharded binary search
    some = records[0][100:100 + k]
    v = pyref.str2num(some)
    expected = exp.get(v, exp.get(pyref.revcomp(v, k)))
    assert expected is not None
    assert br.get_canonical(some) == expected

    st = br.stats()
    assert st["nb_kmers"] == len(exp)
    # shard_entries are super-k-mer ROWS since round 5 (the arena is the
    # only index state); every k-mer lives in some row
    from brisk_tpu.index import sklstore
    s_max = sklstore.skl_dims(k, m, b)[1]
    assert sum(st["shard_entries"].values()) * s_max >= len(exp)

    # sharded checkpoint round-trip
    ckpt = str(tmp_path / "ckpt.npz")
    br.save(ckpt)
    br2 = ShardedBrisk.load(ckpt, mesh=mesh)
    assert br2.counts_dict() == exp
    assert br2.n_emitted == br.n_emitted

    # query_file parity with the single-chip facade
    from brisk_tpu.api import Brisk
    ref = Brisk(Parameters(k=k, m=m, b=b), batch=16, window=64)
    ref.insert_file(path)
    assert br.query_file(path) == ref.query_file(path)


def test_facade_skewed_input_spills_without_loss(tmp_path, mesh):
    """Adversarial skew (poly-A-heavy genome -> few hot buckets) with a
    tiny route_cap: spills happen, counts stay exact (GROGRO analog)."""
    k, m, b = 31, 11, 8
    rng = random.Random(7)
    records = []
    for _ in range(12):
        seq = "".join("A" if rng.random() < 0.9
                      else rng.choice("CGT") for _ in range(500))
        records.append(seq)
    path = str(tmp_path / "skew.fa")
    write_fa(path, records)

    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=8, window=64, stack=2,
                      skl_route_cap=2, capacity=1 << 15)
    br.insert_file(path)
    assert br.n_spilled > 0  # the tiny cap must actually trigger the path
    assert br.counts_dict() == pyref.count_fasta(path, k, m)


def test_facade_streaming_k63(tmp_path, mesh):
    """k > 32 falls back to the streaming carry path (BatchPacker)."""
    k, m, b = 63, 21, 14
    records = [rand_seq(random.randint(k, 300)) for _ in range(12)]
    path = str(tmp_path / "in63.fa")
    write_fa(path, records)

    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=4, window=64, capacity=1 << 15)
    br.insert_file(path)
    assert br.counts_dict() == pyref.count_fasta(path, k, m)


def test_facade_skl_kff_roundtrip(tmp_path, mesh):
    """Per-shard super-k-mer arenas export to one KFF file whose counts
    round-trip exactly (VERDICT r2 item 5; mirrors test_kff's single-chip
    version)."""
    from brisk_tpu.io import kff
    k, m, b = 31, 11, 8
    records = [rand_seq(random.randint(k, 600)) for _ in range(10)]
    path = str(tmp_path / "in.fa")
    write_fa(path, records)
    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=8, window=64, stack=2,
                      capacity=1 << 15)
    br.insert_file(path)
    out = str(tmp_path / "index.kff")
    br.write_kff(out)
    counts, rk, rm = kff.read_index(out)
    assert (rk, rm) == (k, m)
    assert counts == br.counts_dict() == pyref.count_fasta(path, k, m)
    ss = br.skl_stats()
    assert ss["nb_live_kmers"] == len(counts)
    assert ss["avg_kmers_per_skl"] > 2


def test_facade_reallocate_preserves_counts(tmp_path, mesh):
    """reallocate (m+=2, b+=2) re-keys and re-routes every entry with
    exact counts and a rebuilt skl arena (VERDICT r2 item 5)."""
    k, m, b = 31, 11, 8
    records = [rand_seq(random.randint(k, 400)) for _ in range(8)]
    path = str(tmp_path / "in.fa")
    write_fa(path, records)
    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=8, window=64, stack=2,
                      capacity=1 << 15)
    br.insert_file(path)
    before = br.counts_dict()
    br.reallocate()
    assert br.params.m == m + 2 and br.params.b == b + 2
    assert br.counts_dict() == before
    # skl arena matches the re-keyed store
    ss = br.skl_stats()
    assert ss["nb_live_kmers"] == len(before)


def test_facade_shard_programs_run_on_their_own_device(tmp_path, mesh):
    """Each shard's arena view lives on its own device alone, so the
    per-shard finalize is a one-device program whose result stays there
    (not a program replicated over the whole mesh)."""
    from brisk_tpu.index import sklstore
    k, m, b = 31, 11, 8
    path = str(tmp_path / "in.fa")
    write_fa(path, [rand_seq(3000) for _ in range(4)])
    br = ShardedBrisk(Parameters(k=k, m=m, b=b), mesh=mesh,
                      batch_per_shard=8, window=128, stack=2)
    br.insert_file(path)
    devs = list(np.asarray(mesh.devices).reshape(-1))
    shards = list(br._local_skl())
    assert [d for d, _ in shards] == list(range(8))
    for d, lskl in shards:
        for name, arr in lskl._asdict().items():
            assert arr.devices() == {devs[d]}, (d, name)
        fin = sklstore.finalize_device(lskl, k, m, b)
        assert fin.bucket.devices() == {devs[d]}
    br.finalize()
    assert br.skl.bucket.sharding.device_set == set(devs)
    assert br.stats()["nb_emitted"] == sum(
        len(r) - k + 1 for r in pyref.read_fasta_chunks(path))
