"""Benchmark: PRODUCT-path k-mer indexing throughput on the GPU.

Every metric is measured on a code path the product actually runs, and
every stage either reports a number or an explicit *_error field.

  * value (primary): device throughput of pipeline.insert_flat_sklnative
    — THE program Brisk.insert_file dispatches (packed flat chunks from
    a real WindowPacker over a synthetic genome, steady state).
  * e2e_warm_kmers_per_sec: Brisk.insert_file + finalize on a 50 Mb FASTA
    (host parse + packing + H2D + device + count consolidation), after
    Brisk.warmup().
  * e2e_cold_kmers_per_sec: same run INCLUDING warmup()'s executable
    build/load.
  * stage_*_s: per-stage wall times of the e2e run.
  * k63_e2e_kmers_per_sec: k=63 m=21 b=14 e2e on a 4.6 Mb FASTA + its
    repaired-window count.
  * query_file_kmers_per_sec: batch query over the same 50 Mb file
    against the finalized index (reference query path,
    counter.cpp:281-346).

Every timing ends in jax.block_until_ready. The record names the device
(platform, device_kind, count) and the card's power limit; without a GPU
the bench exits non-zero. Prints ONE JSON line.
"""

import json
import os
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from make_synth_fasta import card_info, synth_fasta  # noqa: E402


def product_device_bench():
    """Steady-state throughput of the fused product insert program on
    real (packed) window stacks (exactly what Brisk.insert_file
    dispatches)."""
    from brisk_tpu.index import pipeline, sklstore
    from brisk_tpu.io import windows

    k, m, b = 31, 11, 8
    B, W, S = 2048, 512, 8
    row_cap = max(16, W // 4)
    packer = windows.WindowPacker(k, m, batch=B, l_out=W)

    rng = np.random.default_rng(1234)
    rec = rng.integers(0, 4, 24_000_000, dtype=np.uint8)
    stacks = []
    for fl in packer.pack_flat(iter([rec]), S):
        stacks.append((
            jnp.asarray(fl.chunk4),
            jnp.asarray(fl.valid_start.reshape(S, B)),
            jnp.asarray(fl.valid_end.reshape(S, B)),
            int(fl.n_kmers)))
        if len(stacks) == 3:
            break

    _, _, _, nw = sklstore.skl_dims(k, m, b)
    flush_rows = S * B * row_cap
    skl = sklstore.empty(1 << max(14, (4 * flush_rows - 1).bit_length()),
                         1 << 14, nw)

    chain = pipeline.zero_chain()

    def flush(sk, ch, st):
        out = pipeline.insert_flat_sklnative(
            sk, st[0], st[1], st[2], ch, k=k, m=m, b=b, row_cap=row_cap,
            l_buf=packer.l_buf, useful=packer.useful)
        return out[0], out[6], out[5]

    skl, chain, nr = flush(skl, chain, stacks[0])  # compile + load
    jax.block_until_ready(skl)

    n_kmers = sum(st[3] for st in stacks)
    times = []
    for _ in range(3):
        t0 = time.time()
        last = None
        for st in stacks:
            skl, chain, last = flush(skl, chain, st)
        jax.block_until_ready(skl)
        times.append(time.time() - t0)
        # keep the arena from filling across trials
        skl = skl._replace(n_rows=jnp.int32(0))
    return n_kmers / min(times)


def e2e_bench():
    """Brisk.insert_file + finalize on a 50 Mb synthetic FASTA, then a
    full-file batch query against the finalized index."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    path = synth_fasta(50_000_000, 10_000, 1234)
    br = Brisk(Parameters(k=31, m=11, b=8), batch=2048, window=512,
               stack=8)
    t_cold0 = time.time()
    br.warmup(os.path.getsize(path), path=path)
    t0 = time.time()
    stage_warmup = t0 - t_cold0
    br.insert_file(path)
    jax.block_until_ready(br.skl)
    t1 = time.time()
    stage_insert = t1 - t0
    br.finalize()
    jax.block_until_ready(br.skl)
    t2 = time.time()
    stage_finalize = t2 - t1
    n = br.n_emitted
    out = dict(
        e2e_warm_kmers_per_sec=round(n / (t2 - t0)),
        e2e_cold_kmers_per_sec=round(n / (t2 - t_cold0)),
        stage_warmup_s=round(stage_warmup, 2),
        stage_insert_s=round(stage_insert, 2),
        stage_finalize_s=round(stage_finalize, 2),
        e2e_nb_kmers=n,
        e2e_repaired_windows=br.n_repaired_windows,
        e2e_skl_overflows=br.n_skl_overflows,
    )
    ss = br.skl_stats()
    out.update(
        resident_bytes_per_kmer=round(ss["bytes_per_kmer"], 2),
        avg_kmers_per_superkmer_row=round(ss["avg_kmers_per_skl"], 2),
    )
    t3 = time.time()
    total = br.query_file(path)
    t4 = time.time()
    out.update(
        query_file_kmers_per_sec=round(n / (t4 - t3)),
        query_file_total_mod256=int(total) & 0xFFFFFFFF,
        stage_query_s=round(t4 - t3, 2),
    )
    return out


def k63_e2e_bench():
    """k=63 m=21 b=14 e2e on 4.6 Mb (the reference's own debug config,
    counter.cpp:32 / debug.sh)."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    path = synth_fasta(4_600_000, 10_000, 1234)
    br = Brisk(Parameters(k=63, m=21, b=14), batch=1024, window=512,
               stack=4)
    t_cold0 = time.time()
    br.warmup(os.path.getsize(path), record_len_hint=10_000, path=path)
    t0 = time.time()
    br.insert_file(path)
    br.finalize()
    jax.block_until_ready(br.skl)
    t1 = time.time()
    n = br.n_emitted
    return dict(
        k63_e2e_kmers_per_sec=round(n / (t1 - t0)),
        k63_warmup_s=round(t0 - t_cold0, 2),
        k63_nb_kmers=n,
        k63_repaired_windows=br.n_repaired_windows,
        k63_repair_batches=br.n_repair_batches,
    )


def k63_short_read_bench():
    """k=63 on 150 bp reads — the dominant real-world input shape: the
    adaptive lane geometry must keep the rate within ~2x of the 10 kb-read
    rate instead of leaving lanes ~95% idle."""
    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    path = synth_fasta(4_600_000, 150, 1234)
    br = Brisk(Parameters(k=63, m=21, b=14), batch=4096, window=512,
               stack=4)
    t_cold0 = time.time()
    br.warmup(os.path.getsize(path), record_len_hint=150, path=path)
    t0 = time.time()
    br.insert_file(path)
    br.finalize()
    jax.block_until_ready(br.skl)
    t1 = time.time()
    n = br.n_emitted
    return dict(
        k63_shortread_kmers_per_sec=round(n / (t1 - t0)),
        k63_shortread_warmup_s=round(t0 - t_cold0, 2),
        k63_shortread_nb_kmers=n,
    )


def scale_500mb_bench():
    """500 Mb ingest: mid-ingest segment finalizes bound the consolidation working set; records peak host
    RSS, segment count, and the rate degradation vs the 50 Mb run."""
    import resource

    from brisk_tpu.api import Brisk
    from brisk_tpu.params import Parameters
    path = synth_fasta(500_000_000, 10_000, 1234)
    br = Brisk(Parameters(k=31, m=11, b=8), batch=2048, window=512,
               stack=8)
    t_cold0 = time.time()
    br.warmup(os.path.getsize(path), path=path)
    t0 = time.time()
    br.insert_file(path)
    jax.block_until_ready(br.skl)
    t1 = time.time()
    br.finalize()
    jax.block_until_ready(br.skl)
    t2 = time.time()
    n = br.n_emitted
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return dict(
        scale500_kmers_per_sec=round(n / (t2 - t0)),
        scale500_warmup_s=round(t0 - t_cold0, 2),
        scale500_insert_s=round(t1 - t0, 2),
        scale500_finalize_s=round(t2 - t1, 2),
        scale500_nb_kmers=n,
        scale500_segments=len(br._skl_segments),
        scale500_skl_overflows=br.n_skl_overflows,
        scale500_host_rss_gb=round(rss_gb, 2),
    )


def run_stage(rec, name, fn):
    """Run one bench stage; on failure record an explicit error field
    (never a silently-empty result)."""
    t0 = time.time()
    try:
        out = fn()
        print(f"[bench] {name} done in {time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)
        return out
    except Exception as e:
        traceback.print_exc()
        print(f"[bench] {name} FAILED in {time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)
        rec[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
        return {}


def main():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        sys.exit(2)
    import brisk_tpu
    brisk_tpu.enable_persistent_cache()
    rec = dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
               device_count=len(devs), card=card_info())
    t0 = time.time()
    value = product_device_bench()  # primary: let exceptions kill rc
    print(f"[bench] product_device_bench done in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    rec.update({
        "metric": "product_device_kmers_per_sec_single_chip_k31",
        "value": round(value),
        "unit": "kmers/s",
    })
    rec.update(run_stage(rec, "e2e", e2e_bench))
    rec.update(run_stage(rec, "k63", k63_e2e_bench))
    rec.update(run_stage(rec, "k63_short", k63_short_read_bench))
    rec.update(run_stage(rec, "scale500", scale_500mb_bench))
    print(json.dumps(rec))
    if any(k.endswith("_error") for k in rec):
        sys.exit(3)  # loud failure; the primary metric is still printed


if __name__ == "__main__":
    main()
