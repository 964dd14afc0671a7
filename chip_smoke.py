#!/usr/bin/env python3
"""Smoke test of the k-mer index on the GPU: the quickest proof that the
system starts on the card and gives exact answers there.

One process drives the main path once through the entry points a user
calls, and checks each result against the repository's plain references:

  (a) device     JAX's first device is a GPU; the card's name and power
                 limit (nvidia-smi) are printed.
  (b) kernels    the finalize span expansion (J-major, as compiled for the
                 card) bit-exact against the row-major reference at
                 R = 2^23 rows, k=31 m=11 b=8 (W=3) and b=14 (W=4), with
                 its time; the decycling class of all 4^11 m-mers
                 (compensated float32 on the card) against a float64
                 evaluation of the same contribution tables.
  (c) cli        brisk_tpu.apps.counter --mode 2 -q (full-dictionary parity
                 against oracle/pyref.py) on a seeded 2 Mb FASTA, at the
                 CLI defaults k=31 m=15 b=14 and at k=63 m=21 b=14.
  (d) real size  api.Brisk warmup -> insert_file -> finalize -> query_file
                 -> get_many on a seeded 50 Mb FASTA of 10 kb records,
                 k=31 m=11 b=8.
  (e) sharded    with --chips 4, and then alone: ShardedBrisk over four
                 cards against api.Brisk on device 0, plus a forced-spill
                 run against the oracle.

Usage:
    python chip_smoke.py               # phases (a)-(d) on one card
    python chip_smoke.py --chips 4     # phases (a) and (e) on four cards
    python chip_smoke.py --phase b     # (a) and only the named phase(s)

Inputs are generated from --seed into .smoke_data/ inside the checkout.
Exits non-zero, printing no result, when JAX finds no GPU; exits 1 when
any phase fails. The last line of stdout is one JSON object.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import brisk_tpu
from brisk_tpu import native
from brisk_tpu.api import Brisk
from brisk_tpu.apps import counter
from brisk_tpu.index import sklstore, store
from brisk_tpu.ops import decycling
from brisk_tpu.oracle import pyref
from brisk_tpu.parallel.facade import ShardedBrisk
from brisk_tpu.params import Parameters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from make_synth_fasta import card_info, random_span, synth_fasta  # noqa: E402

CARD = ""  # "name, power.limit" of the card, appended to every time


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def log_time(what: str, seconds: float) -> None:
    log(f"time {what}: {seconds:.6f} s  [{CARD or 'no card'}]")


class CompileCounter:
    """Counts XLA backend compiles and persistent-cache hits of this
    process through jax.monitoring (a cache hit still passes through the
    backend-compile span, so fresh compiles = spans - hits)."""
    def __init__(self):
        self.spans = 0
        self.hits = 0

        def on_duration(event, duration, **kw):
            if event == "/jax/core/compile/backend_compile_duration":
                self.spans += 1

        def on_event(event, **kw):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self):
        return self.spans - self.hits, self.hits


def fasta_records(path: str) -> list:
    """Record sequences of a FASTA, as raw strings (headers dropped)."""
    recs, cur = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if cur:
                    recs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        recs.append("".join(cur))
    return recs


def n_kmers_expected(path: str, k: int) -> int:
    """Sum over the ACGT runs of every record of (len - k + 1)."""
    total = 0
    for rec in fasta_records(path):
        raw = np.frombuffer(rec.upper().encode(), dtype=np.uint8)
        ok = np.isin(raw, np.frombuffer(b"ACGT", dtype=np.uint8))
        edges = np.diff(np.concatenate(([0], ok.view(np.int8), [0])))
        lens = np.nonzero(edges == -1)[0] - np.nonzero(edges == 1)[0]
        total += int(np.maximum(lens - k + 1, 0).sum())
    return total


# -- (b) kernels at real widths ------------------------------------------

def decycling_classes_f64(vals: np.ndarray, m: int) -> np.ndarray:
    """memDouble class of each m-mer in float64, summed in the reference's
    order (pyref.DecyclingSet.compute_r: last base first) from the
    decycling module's contribution tables."""
    WR, WT = decycling.contribution_tables(m)
    v = [((vals >> np.uint64(2 * (m - 1 - j))) & np.uint64(3)).astype(
        np.intp) for j in range(m)]
    r = np.zeros(vals.shape, dtype=np.float64)
    for j in range(m - 1, 0, -1):
        r = r + WR[j][v[j]]
    t = np.zeros(vals.shape, dtype=np.float64)
    for j in range(m - 2, -1, -1):
        t = t + WT[j][v[j]]
    eps = 0.000001
    cls = np.full(vals.shape, 2, dtype=np.uint32)
    cls[(r > eps) & (t < eps)] = 0
    cls[(r < -eps) & (t > -eps)] = 1
    return cls


def time_device(fn, *args, reps: int = 5) -> float:
    """Median wall time of fn(*args) to block_until_ready, after one
    compiling call."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def time_finalize(sb, sm, sn, k: int, m: int, b: int, s_max: int,
                  reps: int = 5) -> float:
    """Median wall time of the fused fresh-span finalize program
    (sklstore._finalize_span_fused: bucket sort, J-major expansion,
    chunked consolidation, totals interleave) over the span rows, on
    fresh copies of its donated inputs, after one compiling call."""
    R = sb.shape[0]
    data = jnp.zeros(R * s_max, jnp.uint32)
    offs = jnp.zeros(R, jnp.uint32)
    times = []
    for i in range(reps + 1):
        args = jax.block_until_ready(
            [jnp.copy(x) for x in (sb, sm, sn, data, offs)])
        t0 = time.perf_counter()
        jax.block_until_ready(sklstore._finalize_span_fused(
            *args, jnp.int32(0), jnp.int32(R), k=k, m=m, b=b, s_max=s_max,
            R_pad=R, carry_counts=False, drop_dead=False))
        if i:
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_kernels(R: int = 1 << 23, configs=((31, 11, 8), (31, 15, 14)),
                  m_dec: int = 11, seed: int = 0, reps: int = 5) -> dict:
    out = {"ok": True}
    for k, m, b in configs:
        sb, sm, sn, s_max = random_span(R, k, m, b, seed + b)
        W = store.key_words(k, b)
        jm = jax.jit(lambda x, y, z: sklstore._expand_span_jmajor(
            x, y, z, k, m, b, s_max))
        rm = jax.jit(lambda x, y, z: sklstore._expand_span(
            x, y, z, k, m, b, s_max)[0])

        @jax.jit
        def same(a, r):
            want = r.reshape(W, R, s_max).transpose(0, 2, 1)
            return jnp.array_equal(a.reshape(W, s_max, R), want)

        equal = bool(same(jm(sb, sm, sn), rm(sb, sm, sn)))
        name = f"k{k}_m{m}_b{b}_W{W}_R{R}"
        log(f"(b) expansion J-major == row-major, {name}: {equal}")
        out[f"expand_{name}_exact"] = equal
        out["ok"] &= equal
        if reps:
            t_jm = time_device(jm, sb, sm, sn, reps=reps)
            t_rm = time_device(rm, sb, sm, sn, reps=reps)
            t_fin = time_finalize(sb, sm, sn, k, m, b, s_max, reps=reps)
            log_time(f"(b) expand J-major (XLA) {name}", t_jm)
            log_time(f"(b) expand row-major reference {name}", t_rm)
            log_time(f"(b) fused fresh-span finalize {name}", t_fin)
            out[f"expand_{name}_jmajor_s"] = t_jm
            out[f"expand_{name}_rowmajor_s"] = t_rm
            out[f"finalize_{name}_s"] = t_fin
        del sb, sm, sn
    vals = np.arange(1 << (2 * m_dec), dtype=np.uint64)
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    got = np.asarray(jax.jit(lambda a, c: decycling.mem_double(
        a, c, m_dec))(lo, hi))
    want = decycling_classes_f64(vals, m_dec)
    n_bad = int((got != want).sum())
    log(f"(b) decycling classes of all 4^{m_dec} m-mers: {n_bad} differ "
        f"from float64 (class counts {np.bincount(want, minlength=3)})")
    out["decycling_mismatches"] = n_bad
    out["ok"] &= n_bad == 0
    return out


# -- (c) the counter CLI, in process ---------------------------------------

def phase_cli(path: str, configs=((31, 15, 14), (63, 21, 14)),
              extra_args=()) -> dict:
    out = {"ok": True}
    for k, m, b in configs:
        argv = ["-f", path, "-k", str(k), "-m", str(m), "-b", str(b),
                "--mode", "2", "-q", path, *extra_args]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                counter.main(argv)
                rc = 0
            except SystemExit as e:  # the CLI exits 1 on a count error
                rc = e.code
        dt = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"(c) k={k}: {line}")
        good = rc in (0, None) and "All counts are correct !" in text \
            and "Query total:" in text
        log_time(f"(c) counter --mode 2 -q, k={k} m={m} b={b}", dt)
        out[f"cli_k{k}_m{m}_b{b}_correct"] = good
        out["ok"] &= good
    return out


# -- (d) real size through api.Brisk --------------------------------------

def expected_gets(records, queries, k: int, m: int) -> list:
    """What Brisk.get returns for each query k-mer, from the pure-Python
    oracle over `records` alone: entries keyed (hashed k-mer, minimizer
    index) as the enumerator stores them; each query keyed by its own
    minimizer decomposition (pyref.str2kmer_record)."""
    dede = pyref.get_decycling(m)
    entries = {}
    for rec in records:
        for chunk in pyref.clean_chunks(rec):
            if len(chunk) < k:
                continue
            for e, _, _ in pyref.scan_emissions(chunk, k, m, dede):
                key = (pyref.hash_kmer_minimizer(e.kmer, e.minimizer_idx,
                                                 m, dede), e.minimizer_idx)
                entries[key] = entries.get(key, 0) + 1
    out = []
    for s in queries:
        q = pyref.str2kmer_record(s, m, dede)
        key = (pyref.hash_kmer_minimizer(q.kmer, q.minimizer_idx, m, dede),
               q.minimizer_idx)
        c = entries.get(key)
        out.append(None if c is None else c % 256)
    return out


def sample_kmers(path: str, k: int, n_records: int, seed: int):
    """(records, every k-mer of them) for n_records seeded records."""
    recs = fasta_records(path)
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(len(recs), min(n_records, len(recs)),
                             replace=False))
    sample = [recs[i] for i in pick]
    kmers = [c[i:i + k] for r in sample for c in pyref.clean_chunks(r)
             for i in range(len(c) - k + 1)]
    return sample, kmers


def random_kmers(n: int, k: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = letters[rng.integers(0, 4, (n, k))]
    return [row.tobytes().decode() for row in codes]


def peak_bytes() -> int:
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def phase_real(path: str, k: int = 31, m: int = 11, b: int = 8,
               batch: int = 2048, window: int = 512, stack: int = 8,
               n_sample_records: int = 100, n_absent: int = 100_000,
               seed: int = 0, compiles=None) -> dict:
    out = {"ok": True}
    n_exp = n_kmers_expected(path, k)
    br = Brisk(Parameters(k=k, m=m, b=b), batch=batch, window=window,
               stack=stack)
    t0 = time.perf_counter()
    br.warmup(path=path)
    log_time("(d) warmup", time.perf_counter() - t0)
    c0 = compiles.snapshot() if compiles else (0, 0)
    stages = {}
    t = time.perf_counter()
    br.insert_file(path)
    jax.block_until_ready(br.skl.bucket)
    stages["insert_file"] = time.perf_counter() - t
    t = time.perf_counter()
    br.finalize()
    jax.block_until_ready(br.skl.data)
    stages["finalize"] = time.perf_counter() - t
    t = time.perf_counter()
    total = br.query_file(path)
    stages["query_file"] = time.perf_counter() - t
    sample, kmers = sample_kmers(path, k, n_sample_records, seed)
    absent = random_kmers(n_absent, k, seed + 1)
    t = time.perf_counter()
    got = br.get_many(kmers)
    got_absent = br.get_many(absent)
    stages["get_many"] = time.perf_counter() - t
    c1 = compiles.snapshot() if compiles else (0, 0)
    for name, dt in stages.items():
        log_time(f"(d) {name}", dt)
    log(f"(d) compiles inside the timed part: {c1[0] - c0[0]} "
        f"(cache hits {c1[1] - c0[1]}); peak device bytes {peak_bytes()}")
    t = time.perf_counter()
    want = expected_gets(sample, kmers, k, m)
    log_time("(d) pure-Python oracle for the get_many sample",
             time.perf_counter() - t)
    slots = br.skl_stats()["nb_slots"]
    checks = {
        "n_emitted == sum(len - k + 1)": br.n_emitted == n_exp,
        "skl nb_slots == n_emitted": slots == br.n_emitted,
        # every k-mer of the seeded random input occurs once, so each
        # emission finds a count of 1
        "query_file total == n_emitted": total == br.n_emitted,
        f"get_many == oracle on {len(kmers)} sampled k-mers": got == want,
        f"get_many of {n_absent} absent k-mers is None":
            all(g is None for g in got_absent),
    }
    log(f"(d) n_emitted {br.n_emitted} expected {n_exp}; nb_slots {slots};"
        f" query total {total}; sample hits "
        f"{sum(g is not None for g in got)}/{len(got)}")
    for what, good in checks.items():
        log(f"(d) {what}: {good}")
        out["ok"] &= bool(good)
    out.update(n_emitted=br.n_emitted, peak_bytes=peak_bytes(),
               **{f"{s}_s": v for s, v in stages.items()})
    return out


# -- (e) ShardedBrisk over four cards --------------------------------------

def phase_sharded(path: str, spill_path: str, n_devices: int = 4,
                  k: int = 31, m: int = 11, b: int = 8,
                  batch_per_shard: int = 512, window: int = 512,
                  stack: int = 4, n_sample: int = 500,
                  seed: int = 0) -> dict:
    p = Parameters(k=k, m=m, b=b)
    out = {"ok": True}

    def check(what, good):
        log(f"(e) {what}: {good}")
        out["ok"] &= bool(good)

    t = time.perf_counter()
    one = Brisk(p)
    one.insert_file(path)
    one.finalize()
    log_time("(e) api.Brisk on device 0: insert_file + finalize, compiles "
             "included", time.perf_counter() - t)
    t = time.perf_counter()
    sb = ShardedBrisk(p, n_devices=n_devices,
                      batch_per_shard=batch_per_shard, window=window,
                      stack=stack)
    sb.insert_file(path)
    jax.block_until_ready(sb.skl.bucket)
    log_time(f"(e) ShardedBrisk x{n_devices}: insert_file, compiles "
             "included",
             time.perf_counter() - t)
    t = time.perf_counter()
    sb.finalize()
    jax.block_until_ready(sb.skl.data)
    log_time(f"(e) ShardedBrisk x{n_devices}: finalize",
             time.perf_counter() - t)

    mesh_devs = list(np.asarray(sb.mesh.devices).reshape(-1))
    for name in sb.skl._fields:
        arr = getattr(sb.skl, name)
        homes = {s.index[0].start: s.device
                 for s in arr.addressable_shards}
        check(f"arena.{name} shard d on mesh device d, {n_devices} cards",
              arr.sharding.device_set == set(mesh_devs)
              and all(homes.get(d) == mesh_devs[d]
                      for d in range(n_devices)))

    _, kmers = sample_kmers(path, k, 4, seed)
    rng = np.random.default_rng(seed)
    kmers = [kmers[i] for i in rng.choice(len(kmers), min(n_sample,
                                                          len(kmers)),
                                          replace=False)]
    t = time.perf_counter()
    got = [sb.get(s) for s in kmers]
    log_time(f"(e) ShardedBrisk.get x{len(kmers)}", time.perf_counter() - t)
    check(f"ShardedBrisk.get == Brisk.get_many on {len(kmers)} k-mers "
          f"({sum(g is not None for g in got)} hits)",
          got == one.get_many(kmers))
    s1, s4 = one.stats(), sb.stats()
    for key in ("nb_emitted", "nb_kmers"):
        check(f"{key}: one card {s1[key]}, sharded {s4[key]}",
              s1[key] == s4[key])
    check("skl nb_slots equal",
          one.skl_stats()["nb_slots"] == sb.skl_stats()["nb_slots"])
    log(f"(e) rows per shard {s4['shard_entries']}; spilled "
        f"{sb.n_spilled}; peak device-0 bytes {peak_bytes()}")
    del one, sb

    t = time.perf_counter()
    spill = ShardedBrisk(p, n_devices=n_devices, skl_route_cap=2)
    spill.insert_file(spill_path)
    got = spill.counts_dict()
    log_time("(e) forced spill (skl_route_cap=2): insert + counts_dict",
             time.perf_counter() - t)
    check(f"forced spill moved rows to source shards ({spill.n_spilled})",
          spill.n_spilled > 0)
    check("forced spill counts_dict == oracle",
          got == pyref.count_fasta(spill_path, k, m))
    return out


# -- driver ------------------------------------------------------------------

def run_phase(results: dict, name: str, fn, *args, **kw) -> None:
    """Run one phase; a failure is recorded (and the exit code becomes 1)
    so one run reports every phase."""
    t0 = time.perf_counter()
    try:
        res = fn(*args, **kw)
    except Exception:
        traceback.print_exc()
        res = {"ok": False, "error": traceback.format_exc(limit=1)[-300:]}
    log(f"phase {name}: {'ok' if res['ok'] else 'FAILED'} "
        f"({time.perf_counter() - t0:.1f} s)")
    results[name] = res


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run the sharded path (e) and nothing else")
    ap.add_argument("--phase", action="append", choices=("b", "c", "d"),
                    help="run only this one-card phase (repeatable; "
                    "default: b, c and d)")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform} "
              f"({devs[0].device_kind})", file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(devs)} GPUs", file=sys.stderr)
        return 2

    cache = brisk_tpu.enable_persistent_cache()  # before the first compile
    compiles = CompileCounter()
    CARD = card_info()
    print(CARD, flush=True)
    lib = native.load()
    flags = os.environ.get("XLA_FLAGS", "")
    log(f"jax {jax.__version__}; XLA_FLAGS={flags!r}; compile cache {cache}")
    log(f"FASTA parser: "
        f"{'native ' + native.SO_PATH if lib else 'pure-Python'}")
    log(f"(a) devices: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    results = {}
    seed = args.seed
    if lib is None:  # the FASTA phases would take many minutes
        results["native_parser"] = {"ok": False}
    elif args.chips == 4:
        big = synth_fasta(50_000_000, 10_000, seed)
        small = synth_fasta(1_000_000, 10_000, seed + 1)
        run_phase(results, "e_sharded", phase_sharded, big, small,
                  n_devices=4, seed=seed)
    else:
        phases = set(args.phase or "bcd")
        if "b" in phases:
            run_phase(results, "b_kernels", phase_kernels, seed=seed)
        if "c" in phases:
            two = synth_fasta(2_000_000, 10_000, seed + 2)
            run_phase(results, "c_cli", phase_cli, two)
        if "d" in phases:
            big = synth_fasta(50_000_000, 10_000, seed)
            run_phase(results, "d_real", phase_real, big, seed=seed,
                      compiles=compiles)
    n_compiles, n_hits = compiles.snapshot()
    log(f"process total: {n_compiles} XLA compiles, {n_hits} persistent "
        f"cache hits")
    failed = [name for name, r in results.items() if not r["ok"]]
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if failed:
        log(f"FAILED phases: {failed}")
        print(json.dumps({"ok": False, "failed": failed, "device": device}))
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
