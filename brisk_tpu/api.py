"""User-facing Brisk API — the array-program equivalent of `Brisk<DATA>`
(reference Brisk.hpp:23-228).

The reference exposes a pointer-based mutable API guarded by advisory
locks (protect_data/unprotect_data). Functional device arrays dissolve that
entire subsystem (SURVEY §5.2): every mutation is a batched pure update,
so there is nothing to protect. The mapping:

  reference                         brisk_tpu
  --------------------------------  ------------------------------------
  Brisk<DATA>(params)               Brisk(params, ...)
  insert_superkmer(skmer, new?)     insert_sequence(seq) /
                                    insert_file(path)  [batched]
  get(kmer) / get_superkmer(...)    get(kmer_string) / query_file(path)
  protect_data / unprotect_data     (not needed: functional updates)
  next / restart_kmer_enumeration   items() iterator
  stats(...)                        stats()
  reallocate()                      reallocate()  [m+=2, b+=2 re-index]
  BriskWriter::write (KFF)          save(path) / Brisk.load(path)

STORAGE (since round 3): the compacted super-k-mer arena (index.sklstore,
C8) is THE backing store, exactly like the reference whose Bucket<DATA>
holds nothing but SKL records + nucleotide/DATA arenas
(buckets.hpp:19-58, SuperKmerLight.hpp:18-122). Inserts append rows to
the arena; `finalize()` (run lazily before any read) consolidates
duplicate k-mer counts; lookups are served from the finalized arena
(scalar gets probe one bucket's row slice; batch queries run a
sort-merge join against a TRANSIENT expansion). Resident cost is
~(8+4*nw)/avg_skl_size + 4 bytes per k-mer instead of round 2's 16
(packed per-k-mer keys) or 23 (both).

The round-1/2 packed per-k-mer backend (keep_superkmers=False) was
REMOVED in round 4 (VERDICT r3 item 7): it duplicated every layer's
insert/repair/query/save logic for a 16 B/kmer store nothing shipped.
Tests now take their key-level ground truth from the pure-Python oracle
(tests/oracle_keys.py); the packed IndexState itself lives on as the
facade's sharded serving structure and the transient expansion format.
"""

import os
import time
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import pipeline, readout, sklstore, store
from brisk_tpu.io import fasta, windows
from brisk_tpu.oracle import pyref
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.params import Parameters

_INFLIGHT_BYTES = 256 << 20  # host bytes pinned by un-retired flushes
#                       (packed chunks + flags); sized by BYTES, not
#                       count (VERDICT r4 item 10) — typical files retire
#                       everything at drain in ONE batched transfer
#                       (each per-flush retire costs a device round-trip)


class Brisk:
    """Dynamic k-mer -> count index with batched insert/query.

    Insertion runs the fused sequence-parallel pipeline for k <= 32:
    records are split into overlapping windows (io.windows) spread across
    all lanes, a stack of `stack` batches is inserted per device program
    (pipeline.insert_flat_sklnative), and the rare windows whose
    warm-up replay failed the re-sync certificate are re-run exactly
    through the streaming carry path (_repair_window). For k > 32 the
    streaming BatchPacker path is used (one record per lane)."""

    def __init__(self, params: Parameters, batch: int = 512,
                 window: int = 512, stack: int = 8):
        import brisk_tpu
        brisk_tpu.enable_persistent_cache()
        self.params = params
        self.batch = batch
        # the warm-up replay must leave room for useful emissions; large
        # (k - m) configs (e.g. k=63, m=21: warmup 88) bump small windows
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        self.n_emitted = 0
        self.n_superkmers = 0
        self.n_repaired_windows = 0
        self.n_repair_batches = 0  # device calls spent on repairs
        self.n_degraded_windows = 0  # should-not-happen fallbacks taken
        # rows kept per lane in the fused skl segmentation; lanes with
        # more super-k-mers are re-run at full width (rare: avg size is
        # ~6-12 kmers, overflow needs avg < 4)
        self.skl_row_cap = max(16, window // 4)
        self.n_skl_overflows = 0
        self._dirty = False          # raw rows appended since finalize
        self._expanded = None        # cached transient per-kmer view
        self._skl_segments = []      # bucket-grouped row ranges, 1/finalize
        self._host_cache = None      # host copy of the arena (serving gets)
        self._pending = []           # in-flight flush records
        self._count_acc = []         # deferred (n_sk, n_km) device scalars
        self._n_repair_appends = 0   # repair rows appended (drain checks)
        self._rows_ub = 0            # upper bound on skl.n_rows
        self._n_fin_host = 0         # host copy of n_fin_rows
        # segment finalize cadence (row upper bound): bounds the
        # per-finalize expansion working set on huge inputs; high enough
        # that typical (<100 Mb) ingests finalize once at the end with
        # the warmup-predicted shape family. segment_rows and
        # consolidate_max_rows were sized for a 16 GB device, to retune
        # on the H100 (ROADMAP S5/S6)
        self.segment_rows = 1 << 24
        # consolidate_all (merge segments + drop dead rows) triggers when
        # segments exceed this, IF the arena fits a one-shot pass
        self.max_segments = 8
        self.consolidate_max_rows = 1 << 25
        _, _, _, nw = sklstore.skl_dims(params.k, params.m, params.b)
        flush_rows = stack * batch * self.skl_row_cap
        rcap = 1 << max(14, (2 * flush_rows - 1).bit_length())
        self.skl = sklstore.empty(rcap, 1 << 14, nw)

    # -- insertion ---------------------------------------------------------

    def _records(self, path: str):
        """Record stream (uint8 code arrays or ACGT strings), preferring
        the native C++ parser; a warmup(path=...) prefetch is consumed
        here."""
        pf = getattr(self, "_prefetch", None)
        if pf is not None and pf[0] == path:
            self._prefetch = None
            pf[1].join()
            if pf[2]:
                return iter(pf[2][0])
        from brisk_tpu import native
        chunks = native.parse_fasta_codes(path)
        if chunks is not None:
            return iter(chunks)
        return pyref.read_fasta_chunks(path)

    def _presize_for(self, n_bases_estimate: int) -> None:
        """Grow the arena ONCE up front to what the input will need:
        mid-run growth changes array shapes, and every new shape pays an
        executable compile (or a cache load). Estimate: at most
        one row per 5 k-mers (denser inputs grow mid-run; typical
        data sits at ~6 k-mers/row), plus a few flushes of in-flight
        slack (NOT _INFLIGHT_DEPTH-proportional: the worst-case per-flush
        row bound is loose, and capacity pressure triggers a drain +
        exact re-check anyway — depth 32 would inflate the arena 8x and
        change every downstream executable shape)."""
        flush_rows = self.stack * self.batch * self.skl_row_cap
        est = n_bases_estimate // 5 + 5 * flush_rows
        self.skl = sklstore.ensure_room(self.skl, max(0, est
                                                      - int(self.skl.n_rows)))

    def _stream_geometry(self, rec_len=None) -> "fasta.BatchPacker":
        """Lane geometry for the k > 32 streaming path. One record rides
        one lane, so lane OCCUPANCY is record_len / l_buf: the round-4
        fixed l_buf = window+margin left short-read sets (150-300 bp,
        the dominant real-world input) ~70-95% idle (VERDICT r4 item 7).
        l_new adapts to the record-length profile, quantized to 64 so
        the executable set stays bounded; long records still stream
        across batches in the same lane."""
        p = self.params
        if rec_len is None:
            l_new = self.window
        else:
            l_new = min(self.window,
                        max(64, -(-(rec_len - (p.k - 1)) // 64) * 64))
        return fasta.BatchPacker(p.k, self.batch, l_new)

    def warmup(self, n_bases_estimate: int = 0,
               record_len_hint: int = None, path: str = None) -> None:
        """Compile/load the insert program for this instance's shapes
        (pay the executable build at startup, not on the first
        request). Pass the expected input size so the arena is
        presized to the same shape insert_file will use; for k > 32
        short-read inputs pass record_len_hint so the adaptive lane
        geometry preloads the right program. Runs one empty window
        stack; no rows or counts result from it."""
        import threading
        p = self.params
        if path is not None and not n_bases_estimate:
            try:
                n_bases_estimate = os.path.getsize(path)
            except OSError:
                pass
        if n_bases_estimate:
            self._presize_for(n_bases_estimate)
        S, B = self.stack, self.batch
        jobs = []
        if path is not None:
            # prefetch-parse the input during warmup (the native parse
            # is ~0.25 s/50 Mb of pure host work; insert_file consumes
            # the result via _records)
            box = []

            def parse():
                from brisk_tpu import native
                chunks = native.parse_fasta_codes(path)
                if chunks is not None:
                    box.append(chunks)

            t = threading.Thread(target=parse)
            self._prefetch = (path, t, box)
            jobs.append(t)

        def load_insert():
            if p.k > 32:  # streaming program (see _insert_streaming)
                spacker = self._stream_geometry(record_len_hint)
                out = pipeline.insert_stream_sklnative(
                    self.skl, jnp.zeros((S, B, spacker.l_buf), jnp.uint8),
                    jnp.ones((S, B), bool), jnp.zeros((S, B), jnp.int32),
                    enum_ops.zero_carry(B), k=p.k, m=p.m, b=p.b,
                    row_cap=spacker.l_new)
                self.skl = out[0]
                jax.block_until_ready(out[4])
            else:
                packer = windows.WindowPacker(p.k, p.m, self.batch,
                                              l_out=self.window)
                u4 = packer.useful // 4
                nparts = -(-packer.l_buf4 // u4)
                chunk4_len = (S * B + nparts - 1) * u4
                out = pipeline.insert_flat_sklnative(
                    self.skl, jnp.zeros((chunk4_len,), jnp.uint8),
                    jnp.zeros((S, B), jnp.int32),
                    jnp.zeros((S, B), jnp.int32),
                    pipeline.zero_chain(), k=p.k, m=p.m, b=p.b,
                    row_cap=self.skl_row_cap, l_buf=packer.l_buf,
                    useful=packer.useful)
                self.skl = out[0]
                jax.block_until_ready(out[5])

        jobs.append(threading.Thread(target=load_insert))
        rcap_now = self.skl.bucket.shape[0]
        if n_bases_estimate and rcap_now <= (1 << 26):
            # Pre-load the FINALIZE executables too: every program pays a
            # per-process executable build/load keyed by its shape
            # family; a dummy finalize at the row count the input
            # predicts (~1 row per 6 bases at SKL_SIZE_CAP=8) moves that
            # cost off the serving path. The prediction is approximate
            # (avg super-k-mer size varies with k/content), so BOTH the
            # predicted family and its neighbor run on SCRATCH arenas —
            # covering estimate error up to ~77% — IN PARALLEL with the
            # insert-program load. The 1 << 26 and 1 << 23 caps were
            # sized for a 16 GB device, to retune on the H100 (ROADMAP
            # S5/S6).
            rcap = self.skl.bucket.shape[0]
            nw = self.skl.nucs.shape[0]
            # cap at the segment-finalize span scale: huge inputs never
            # finalize more than ~one segment span at once, and a dummy
            # at the full-input family would need the whole-arena
            # expansion's memory
            est_rows = min(max(1024, n_bases_estimate // 6), rcap // 2,
                           1 << 23)
            fam = sklstore._shape_family(est_rows, floor=1 << 8)
            s_max = sklstore.skl_dims(p.k, p.m, p.b)[1]
            fake_sz = min(6, s_max)

            def load_finalizes():
                # FAKE LIVE rows (size 6 each) so the dummy's total-kmer
                # count — and therefore the data-arena family — matches
                # what the real input will produce. ONE scratch arena,
                # reused between the two family dummies (a fresh
                # full-size arena per dummy tripled peak HBM); runs in
                # parallel with the insert-program load thread.
                iota = jnp.arange(rcap, dtype=jnp.uint32)
                fake = sklstore.empty(rcap, 1 << 14, nw)
                for est in (fam, sklstore._shape_family(fam + 1,
                                                        floor=1 << 8)):
                    if est > rcap // 2:
                        break
                    live = iota < jnp.uint32(est)
                    fake = fake._replace(
                        bucket=jnp.where(live, jnp.uint32(0),
                                         fake.bucket),
                        meta=jnp.where(live,
                                       jnp.uint32(fake_sz
                                                  | (s_max << 8)),
                                       fake.meta),
                        n_rows=jnp.int32(est), n_fin_rows=jnp.int32(0),
                        n_fin_kmers=jnp.int32(0))
                    fake = sklstore.finalize_device(fake, p.k, p.m, p.b)
                    jax.block_until_ready(fake.data)

            jobs.append(threading.Thread(target=load_finalizes))
        for t in jobs:
            t.start()
        for t in jobs:
            t.join()

    def insert_file(self, path: str) -> None:
        """Sequence-parallel windowed insertion for every k (the k > 32
        windows certify by end-state equality, pipeline._chain_exact)."""
        try:
            self._presize_for(os.path.getsize(path))
        except OSError:
            pass
        self._insert_windowed(self._records(path))

    def insert_sequence(self, seq: str) -> None:
        """Counts every k-mer of one sequence (the declared-but-never-
        defined Brisk::insert_sequence, Brisk.hpp:27 — implemented here)."""
        self._insert_windowed(iter([seq]))
        self._drain()  # counters/repairs visible immediately (small input)

    # -- fused sequence-parallel insertion (k <= 32) -------------------------

    def _insert_windowed(self, records) -> None:
        """FLAT transport (round 5): the producer thread runs pack_flat
        (one aligned copy per record + one vectorized pack4 per flush)
        and STAGES the contiguous chunk on-device; the device builds the
        overlapping window lanes itself (pipeline.insert_flat_sklnative).
        Round 4 materialized every window on host — a ~119k-iteration
        Python copy loop per 50 Mb.

        k > 32 routes to the exact streaming path instead: the
        truncation quirk starves the windowed equality certificate
        (30-99% of windows repaired depending on window size), while
        one-record-per-lane streaming is sequentially exact with ZERO
        repairs (pipeline.insert_stream_sklnative)."""
        import queue
        import threading
        if self.params.k > 32:
            self._insert_streaming(records)
            return
        self._drain()  # leftover flushes of a PREVIOUS stream must
        #                retire before _prev_tail/_chain reset
        p = self.params
        packer = windows.WindowPacker(p.k, p.m, self.batch,
                                      l_out=self.window)
        self._packer = packer
        self._prev_tail = None  # (rec, win, end7) of last lane of prev stack
        self._chain = pipeline.zero_chain()
        S, B = self.stack, self.batch
        q = queue.Queue(maxsize=2)
        err = []

        def producer():
            try:
                for fl in packer.pack_flat(records, S):
                    q.put((fl, jnp.asarray(fl.chunk4),
                           jnp.asarray(fl.valid_start.reshape(S, B)),
                           jnp.asarray(fl.valid_end.reshape(S, B))))
            except BaseException as e:  # surface in the consumer
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            self._dispatch_flush(packer, *item)
        t.join()
        if err:
            raise err[0]
        # NO final drain here: finalize() dispatches its span program
        # behind the in-flight flushes and overlaps the retire
        # bookkeeping with it; every reader drains lazily

    def _insert_streaming(self, records) -> None:
        """k > 32: one record per lane, exact device-resident carry
        across batches/flushes, fused skl-row appends — no warm-up
        replay, no certificates, no repairs. Data-parallel across
        records (the common read-set shape at k = 63)."""
        p = self.params
        # adapt lane length to the record profile (p90) so short-read
        # sets fill their lanes (see _stream_geometry)
        records = list(records)
        lens = sorted(len(r) for r in records if len(r) >= p.k)
        rec_len = lens[max(0, int(0.9 * len(lens)) - 1)] if lens else None
        packer = self._stream_geometry(rec_len)
        if rec_len is not None and rec_len <= packer.l_buf:
            # short-read fast path: records that fit one lane buffer are
            # batch-built with ONE vectorized fancy-index store per
            # batch — BatchPacker's per-record Python lane loop runs
            # ~30k iterations per 4.6 Mb of 150 bp reads
            shorts, longs = [], []
            for r in records:
                if len(r) < p.k:
                    continue
                if isinstance(r, str):
                    raw = np.frombuffer(r.encode(), dtype=np.uint8)
                    r = (raw >> 1) & np.uint8(3)
                (shorts if len(r) <= packer.l_buf else longs).append(r)

            def batches():
                B, l_buf = self.batch, packer.l_buf
                if shorts:
                    slens = np.array([len(r) for r in shorts],
                                     dtype=np.int64)
                    flat = np.concatenate(shorts)
                    starts = np.zeros(len(shorts) + 1, dtype=np.int64)
                    np.cumsum(slens, out=starts[1:])
                    for g0 in range(0, len(shorts), B):
                        g1 = min(g0 + B, len(shorts))
                        lg = slens[g0:g1]
                        codes = np.zeros((B, l_buf), dtype=np.uint8)
                        lane = np.repeat(
                            np.arange(g1 - g0, dtype=np.int64), lg)
                        within = (np.arange(int(lg.sum()),
                                            dtype=np.int64)
                                  - np.repeat(starts[g0:g1]
                                              - starts[g0], lg))
                        codes.reshape(-1)[lane * l_buf + within] = \
                            flat[starts[g0]:starts[g1]]
                        ve = np.zeros(B, dtype=np.int32)
                        ve[:g1 - g0] = lg
                        yield fasta.Batch(codes, np.ones(B, dtype=bool),
                                          ve, int((lg - p.k + 1).sum()))
                if longs:
                    yield from packer.pack(iter(longs))

            records = batches()
            self._insert_stream_batches(packer, records)
            return
        records = iter(records)
        self._insert_stream_batches(packer, packer.pack(records))

    def _insert_stream_batches(self, packer, batch_iter) -> None:
        """Flush an iterator of fasta.Batch through the streaming
        program (shared by the generic BatchPacker path and the
        vectorized short-read builder)."""
        p = self.params
        S, B = self.stack, self.batch
        row_cap = packer.l_new  # full width: segmentation cannot overflow
        carry = enum_ops.zero_carry(B)
        flush_rows = S * B * row_cap
        pending = []

        def flush(batches):
            nonlocal carry
            if self._rows_ub + flush_rows > self.skl.bucket.shape[0]:
                self._settle_counts()
                self._rows_ub = int(self.skl.n_rows)
                self.skl = sklstore.ensure_room(self.skl, flush_rows)
            (self.skl, n_sk, n_km, carry,
             _nr) = pipeline.insert_stream_sklnative(
                self.skl, jnp.asarray(np.stack([b.codes for b in batches])),
                jnp.asarray(np.stack([b.fresh for b in batches])),
                jnp.asarray(np.stack([b.valid_end for b in batches])),
                carry, k=p.k, m=p.m, b=p.b, row_cap=row_cap)
            self._count_acc.append((n_sk, n_km, 0))
            self._rows_ub += flush_rows
            self._dirty = True
            self._expanded = None

        for bt in batch_iter:
            pending.append(bt)
            if len(pending) == S:
                flush(pending)
                pending = []
        if pending:
            while len(pending) < S:  # tail pad: fresh empty lanes
                pending.append(fasta.Batch(
                    np.zeros((B, packer.l_buf), np.uint8),
                    np.ones(B, dtype=bool), np.zeros(B, np.int32), 0))
            flush(pending)
        self._drain()

    def _dispatch_flush(self, packer, flush, chunk4_d, vs_d, ve_d
                        ) -> None:
        """Launch one PRE-STAGED flat chunk on the device; bookkeeping
        (counters, certificate repairs, overflow re-runs) is deferred to
        _retire so host packing overlaps device compute (VERDICT r2
        item 1). chunk4_d/vs_d/ve_d are already device-resident (the
        producer thread staged them)."""
        p = self.params
        S, B = self.stack, self.batch
        flush_rows = S * B * self.skl_row_cap
        if self._rows_ub + flush_rows > self.skl.bucket.shape[0]:
            self._drain()  # exact n_rows; grow only if truly needed
            self.skl = sklstore.ensure_room(self.skl, flush_rows)
        (self.skl, n_sk, n_km, flags, ends,
         n_rows_after, self._chain) = pipeline.insert_flat_sklnative(
            self.skl, chunk4_d, vs_d, ve_d, self._chain,
            k=p.k, m=p.m, b=p.b,
            row_cap=self.skl_row_cap, l_buf=packer.l_buf,
            useful=packer.useful)
        self._rows_ub += flush_rows
        self._dirty = True
        self._expanded = None
        # cert+ovf arrive packed IN-PROGRAM (eager astype/or ops here
        # would cost tiny-op dispatches per flush); retire pays a single
        # ~16 KB transfer for them
        self._pending.append(dict(flush=flush, flags=flags, ends=ends,
                                  n_sk=n_sk, n_km=n_km, packer=packer))
        depth = max(4, _INFLIGHT_BYTES // max(flush.chunk4.nbytes, 1))
        if len(self._pending) > depth:
            self._retire(self._pending.pop(0))
        # segment finalize mid-ingest (round 5): consolidating the tail
        # every ~segment_rows bounds the finalize working set (a 500 Mb
        # input would otherwise need a one-shot whole-input expansion)
        # and overlaps consolidation with the remaining transfers
        if self._rows_ub - self._n_fin_host > self.segment_rows:
            self.finalize()

    def _drain(self) -> None:
        if self._pending:
            # ONE transfer for every pending flush's cert/ovf flags AND
            # counter scalars AND the final row count — each separate
            # device_get costs a full device round-trip
            recs, self._pending = self._pending, []
            flags_l, counts_l, n_rows = jax.device_get(
                ([r["flags"] for r in recs],
                 [(r["n_sk"], r["n_km"]) for r in recs],
                 self.skl.n_rows))
            n_appended0 = self._n_repair_appends
            for rec, fl, cnt in zip(recs, flags_l, counts_l):
                rec["counts_np"] = cnt
                self._retire(rec, np.asarray(fl))
            self._settle_counts()
            if self._n_repair_appends == n_appended0:
                self._rows_ub = int(n_rows)  # no repair rows: prefetched
                return
        self._settle_counts()
        self._rows_ub = int(self.skl.n_rows)

    def _settle_counts(self) -> None:
        """Fold the deferred per-flush device counter scalars in ONE
        transfer (per-flush int() readbacks serialize the pipeline on
        the device round-trip latency)."""
        if not self._count_acc:
            return
        flat = jax.device_get([(r[0], r[1]) for r in self._count_acc])
        for (n_sk, n_km), (_, _, n_recs) in zip(flat, self._count_acc):
            self.n_superkmers += int(n_sk) + n_recs
            self.n_emitted += int(n_km)
        self._count_acc = []

    def _retire(self, rec, flags_np=None) -> None:
        """Resolve one flush: fold its counters, repair uncertified lanes
        exactly, re-run skl-overflow lanes at full width.

        Repairs are BATCHED: every failed lane whose predecessor's end
        state is already exact is re-run carry-seeded in ONE device call
        (streaming semantics — no warm-up replay needed when the start
        state is exact); only consecutive-failure runs force further
        passes (pass p repairs the p-th window of each run). k > 32
        configs repair ~half their windows (the truncation quirk starves
        the equality certificate), so per-lane host loops would be a
        repair storm (VERDICT r2 item 4 'repair-all fallback that still
        batches windows')."""
        packer = rec["packer"]
        flush = rec["flush"]
        S, B = self.stack, self.batch
        if "counts_np" in rec:  # batched drain prefetched the scalars
            n_sk, n_km = rec["counts_np"]
            self.n_superkmers += int(n_sk) + flush.n_records
            self.n_emitted += int(n_km)
        else:
            self._count_acc.append((rec["n_sk"], rec["n_km"],
                                    flush.n_records))

        flags = (np.asarray(rec["flags"]) if flags_np is None
                 else flags_np).reshape(-1)
        cert_f = (flags & 1).astype(bool)
        rec_f = flush.rec
        win_f = flush.win
        failed = np.nonzero((~cert_f) & (rec_f >= 0))[0]
        repaired_ends = {}
        ends_cache = []

        def ends_f():
            """Materialize the per-lane end states LAZILY: the ~0.5 MB
            transfer only happens for flushes that actually repair (or
            whose tail state a later repair asks for)."""
            if not ends_cache:
                ends_cache.append([np.asarray(x).reshape(S * B)
                                   for x in rec["ends"]])
            return ends_cache[0]

        def end_of(j):
            """Exact end state of flat lane j (certified or repaired)."""
            if j in repaired_ends:
                return repaired_ends[j]
            return tuple(e[j] for e in ends_f())

        # group consecutive failures into runs: a run is a contiguous
        # genome span, so it repairs as ONE streaming lane; independent
        # runs batch across lanes in one device call. Chunk very long
        # runs (cap below) into successive passes (carry dependency).
        MAX_RUN = 64
        runs = []
        for j in (int(x) for x in failed):
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        # Degrade, don't die (VERDICT r3 weak #8): a run head whose exact
        # predecessor state is unavailable (window-0 flagged uncertified,
        # or a continuity-bookkeeping violation) used to hard-assert and
        # kill the ingest. Instead: window 0 certifies by construction —
        # trust its fused insert and only repair successors; a broken
        # chain falls back to a window-local fresh replay (bit-exact
        # except adversarial equal-hash repeats spanning the seam).
        checked = []
        for run in runs:
            j0 = run[0]
            r, w = int(rec_f[j0]), int(win_f[j0])
            if w == 0:
                self._degrade(f"window-0 lane flagged uncertified "
                              f"(record {r}); certified by construction")
                repaired_ends[j0] = tuple(e[j0] for e in ends_f())
                if run[1:]:
                    checked.append(run[1:])
                continue
            if j0 == 0:
                seed_ok = (self._prev_tail is not None
                           and self._prev_tail[:2] == (r, w - 1))
            else:
                seed_ok = (rec_f[j0 - 1] == r and win_f[j0 - 1] == w - 1)
            if not seed_ok:
                self._degrade(f"no exact repair seed for record {r} "
                              f"window {w}; window-local replay")
                repaired_ends[j0] = self._repair_window_unchained(
                    flush, j0)
                self.n_repaired_windows += 1
                if run[1:]:
                    checked.append(run[1:])
                continue
            checked.append(run)
        runs = checked
        while runs:
            # a chunk of a split run must wait for its predecessor chunk
            head = {r[0] for r in runs}
            ready = [r for r in runs if r[0] - 1 not in
                     {j for rr in runs for j in rr}]
            rest = [r for r in runs if r not in ready]
            assert ready, head
            carries = [self._prev_tail[2]() if r[0] == 0
                       else end_of(r[0] - 1)
                       for r in ready]
            end7s = self._repair_runs(packer, flush, ready, carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            self.n_repaired_windows += sum(len(r) for r in ready)
            self.n_repair_batches += 1
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            # end state stays a THUNK: it is only materialized if a
            # failure in the next flush actually needs the seed
            self._prev_tail = (int(rec_f[j]), int(win_f[j]),
                               lambda jj=j: end_of(jj))

        # skl segmentation overflow (certified lanes with more super-k-mers
        # than the fused row budget): rebuild their skl rows at full width
        ovf_f = (flags >> 1).astype(bool)
        for j in np.nonzero(ovf_f & cert_f & (rec_f >= 0))[0]:
            self._repair_skl_overflow(flush, int(j))
            self.n_skl_overflows += 1

    def _append_skl_from_emissions(self, em, valid, first_valid,
                                   row_cap: int) -> None:
        """Build + append compacted super-k-mer rows for a (small) repair
        emission batch at full row width. Dead padding rows are filtered
        host-side so the dense arena stays tombstone-free."""
        p = self.params
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, valid,
            first_valid, em.boundary, p.k, p.m, p.b, row_cap)
        assert not bool(np.any(np.asarray(ovf)))
        rb_f = np.asarray(rb).reshape(-1)
        live = rb_f != np.uint32(0xFFFFFFFF)
        n_live = int(np.count_nonzero(live))
        if not n_live:
            return
        rm_f = np.asarray(rm).reshape(-1)[live]
        rn_f = np.asarray(rn).reshape(rn.shape[0], -1)[:, live]
        self.skl = sklstore.ensure_room(self.skl, n_live)
        self.skl = sklstore.append(self.skl, jnp.asarray(rb_f[live]),
                                   jnp.asarray(rm_f), jnp.asarray(rn_f))
        self._rows_ub += n_live
        self._n_repair_appends += 1
        self._dirty = True
        self._expanded = None

    def _degrade(self, msg: str) -> None:
        """Log a should-not-happen repair-bookkeeping condition instead
        of asserting (degrade, don't die): a multi-hour ingest must not
        crash when an exact-repair fallback exists one line away."""
        import sys
        self.n_degraded_windows += 1
        print(f"[brisk_tpu] degraded repair: {msg}", file=sys.stderr)

    def _repair_window_unchained(self, flush, j):
        """Window-local fresh replay for one failed lane whose exact
        predecessor state is unavailable: re-run the lane standalone
        exactly as the fused program would have (fresh init + warm-up
        replay masked by valid_start) and ACCEPT its emissions. Bit-exact
        wherever the warm-up re-synced — i.e. always, except adversarial
        equal-hash repeats spanning the window seam. Returns the lane's
        replayed end-state 7-tuple (used to seed successors)."""
        p = self.params
        j = int(j)
        codes1 = jnp.asarray(flush.codes[j][None, :])
        vs1 = jnp.asarray([int(flush.valid_start[j])], dtype=jnp.int32)
        ve1 = jnp.asarray([int(flush.valid_end[j])], dtype=jnp.int32)
        em, _ = enum_ops.enumerate_batch(
            codes1, jnp.ones(1, bool), ve1, enum_ops.zero_carry(1),
            k=p.k, m=p.m, b=p.b, valid_start=vs1)
        valid = em.valid
        self.n_emitted += int(jnp.sum(valid))
        self.n_superkmers += int(jnp.sum(em.boundary & valid))
        margin = p.k - 1
        L_out = em.valid.shape[1]
        pos = jnp.arange(margin, margin + L_out,
                         dtype=jnp.uint32)[None, :]
        first_valid = pos == vs1[:, None].astype(jnp.uint32)
        self._append_skl_from_emissions(em, valid, first_valid, L_out)
        return self._end_states(em, np.asarray([int(ve1[0])]), [0])[0]

    def _end_states(self, em, ve, lanes):
        """Exact per-lane machine-state 7-tuples at each lane's OWN ve
        (the scan's shared final_state is unusable when spans differ):
        every state field is a per-position output; heavy is re-derived
        from the minimizer's decycling class (the hash's top bits,
        hashing.cpp:17)."""
        p = self.params
        km = p.k - p.m
        margin = p.k - 1
        dede = pyref.get_decycling(p.m)
        f_lo = np.asarray(em.mini_lo)
        f_hi = np.asarray(em.mini_hi)
        f_rc = np.asarray(em.use_rc)
        f_mi = np.asarray(em.mini_idx)
        f_hh = np.asarray(em.hash_hi)
        f_hl = np.asarray(em.hash_lo)
        out = []
        for i in lanes:
            idx = int(ve[i]) - margin - 1
            rev = bool(f_rc[i, idx])
            mi = int(f_mi[i, idx])
            pos_v = (km - mi) if rev else mi
            mini = (int(f_hi[i, idx]) << 32) | int(f_lo[i, idx])
            heavy = dede.mem_double(mini)
            out.append((np.uint32(f_lo[i, idx]), np.uint32(f_hi[i, idx]),
                        np.uint32(pos_v), np.bool_(rev), np.uint32(heavy),
                        np.uint32(f_hh[i, idx]), np.uint32(f_hl[i, idx])))
        return out

    def _repair_skl_overflow(self, flush, j) -> None:
        """Re-run one certified lane's skl segmentation at full row width
        (its per-kmer emissions were counted by the fused program but its
        rows were withheld)."""
        p = self.params
        j = int(j)
        codes1 = jnp.asarray(flush.codes[j][None, :])
        vs1 = jnp.asarray([int(flush.valid_start[j])], dtype=jnp.int32)
        ve1 = jnp.asarray([int(flush.valid_end[j])], dtype=jnp.int32)
        em, _ = enum_ops.enumerate_batch(
            codes1, jnp.ones(1, bool), ve1, enum_ops.zero_carry(1),
            k=p.k, m=p.m, b=p.b, valid_start=vs1)
        L_out = em.valid.shape[1]
        margin = p.k - 1
        pos = jnp.arange(margin, margin + L_out, dtype=jnp.uint32)[None, :]
        first_valid = pos == vs1[:, None].astype(jnp.uint32)
        self._append_skl_from_emissions(em, em.valid, first_valid, L_out)

    def _repair_runs(self, packer, flush, runs, carries):
        """Exact re-run of runs of consecutive failed windows through the
        streaming carry path. Each run covers a CONTIGUOUS genome span
        (window w+1 overlaps w by l_buf-useful bases), so the whole run
        is one streaming lane; independent runs ride parallel lanes of
        ONE batched device call (padded to power-of-two shapes for
        compile reuse).

        runs: lists of consecutive flat lane indices; carries: the exact
        predecessor end state per run. Returns the exact end 7-tuple of
        each run's LAST window."""
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        # span padded to a pow2 so the repair program compiles per shape
        # FAMILY, not per exact run length (VERDICT r3 item 3: every new
        # (Rp, L_rep) shape is a fresh multi-second executable load; a
        # heavy-repair k=63 ingest would otherwise spend minutes there)
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int32)
        carry_np = [np.zeros(Rp, dtype=np.asarray(c).dtype)
                    for c in enum_ops.zero_carry(1)]
        win_codes = flush.codes
        for i, (run, c7) in enumerate(zip(runs, carries)):
            pos = l_buf - warmup
            codes[i, :pos] = win_codes[run[0]][warmup:]
            for j in run[1:]:
                codes[i, pos:pos + useful] = win_codes[j][l_buf - useful:]
                pos += useful
            ve[i] = (len(run) - 1) * useful + \
                int(flush.valid_end[run[-1]]) - warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        carry = enum_ops.MinimizerState(*(jnp.asarray(x)
                                          for x in carry_np))
        em, end = enum_ops.enumerate_batch(
            jnp.asarray(codes), jnp.zeros(Rp, bool), jnp.asarray(ve),
            carry, k=p.k, m=p.m, b=p.b)
        valid = em.valid
        self.n_emitted += int(jnp.sum(valid))
        self.n_superkmers += int(jnp.sum(em.boundary & valid))
        margin = p.k - 1
        L_out = em.valid.shape[1]
        pos = jnp.arange(margin, margin + L_out,
                         dtype=jnp.uint32)[None, :]
        first_valid = jnp.broadcast_to(pos == jnp.uint32(margin),
                                       em.valid.shape)
        self._append_skl_from_emissions(em, valid, first_valid, L_out)
        # each run's exact end state at ITS OWN ve (_end_states); note
        # the repair buffer has no warm-up margin offset beyond `margin`
        return self._end_states(em, ve, list(range(R)))

    # -- finalization ------------------------------------------------------

    def finalize(self) -> None:
        """Consolidate the compacted super-k-mer arena (C8): duplicate
        k-mer counts merge onto one slot, dead rows are dropped, rows are
        grouped by bucket, per-slot counts land in the data arena. Runs
        lazily before any read; after it, stats() reports the resident
        super-k-mer memory footprint and KFF export writes whole
        super-k-mer blocks."""
        p = self.params
        # drain first: the span program's R_pad family must come from
        # the EXACT row count — sizing it from the loose in-flight upper
        # bound picked a different shape family than warmup preloaded
        # and paid a fresh executable compile on the serving path
        self._drain()
        f_before = int(self.skl.n_fin_rows)
        self.skl = sklstore.finalize_device(self.skl, p.k, p.m, p.b)
        self._rows_ub = int(self.skl.n_rows)
        f_after = int(self.skl.n_fin_rows)
        if f_after == 0:
            self._skl_segments = []
        elif f_after > f_before:
            # the freshly finalized tail is one new bucket-grouped segment
            self._skl_segments.append((f_before, f_after))
        self._n_fin_host = f_after
        self._host_cache = None
        self._dirty = False
        # maintenance (reference buckets.hpp:166-189 merge analog): merge
        # segments + drop dead rows when probes would scan too many runs
        if (len(self._skl_segments) > self.max_segments
                and f_after <= self.consolidate_max_rows):
            self.consolidate()

    def consolidate(self) -> None:
        """Whole-arena maintenance: merge every segment into one
        bucket-grouped run, fold cross-segment duplicate counts onto one
        slot, drop dead rows (sklstore.consolidate_all). O(n_rows)
        working memory — automatic under consolidate_max_rows, callable
        any time."""
        p = self.params
        self._drain()
        self.skl = sklstore.consolidate_all(self.skl, p.k, p.m, p.b)
        nfr = int(self.skl.n_fin_rows)
        self._skl_segments = [(0, nfr)] if nfr else []
        self._rows_ub = nfr
        self._n_fin_host = nfr
        self._host_cache = None
        self._expanded = None
        self._dirty = False

    def _ensure_final(self) -> None:
        self._drain()
        if self._dirty:
            self.finalize()

    def _expanded_view(self) -> store.IndexState:
        """Transient per-k-mer sorted view of the arena for batch queries
        (working memory, not resident state)."""
        self._ensure_final()
        if self._expanded is None:
            p = self.params
            self._expanded = sklstore.expanded_state(self.skl, p.k, p.m,
                                                     p.b)
        return self._expanded

    # -- lookup ------------------------------------------------------------

    def get_canonical(self, kmer: str) -> Optional[int]:
        """Strand-insensitive count: tries both orientations. The
        reference's str2kmer keying (Kmers.cpp:257-268) only matches
        entries stored in the query's own orientation — minus-strand
        emissions are stored under the RC value and the faithful get()
        misses them, exactly like the reference. This helper is the
        practical lookup."""
        c = self.get(kmer)
        if c is not None:
            return c
        p = self.params
        rc = pyref.num2str(pyref.revcomp(pyref.str2num(kmer), p.k), p.k)
        return self.get(rc)

    def get(self, kmer: str) -> Optional[int]:
        """Count of one k-mer given as an ACGT string, or None if absent.
        Mirrors Brisk::get (Brisk.hpp:63-69): the k-mer is keyed by its own
        minimizer decomposition (orientation-sensitive, like the
        reference — see get_canonical). Served from the finalized arena:
        binary search the bucket's row slice, expand it, compare
        (reference find_kmer, buckets.hpp:499-519)."""
        return self.get_many([kmer])[0]

    def get_many(self, kmers) -> list:
        """Batched point lookups: one vectorized numpy keying pass
        (index.keying — no Python-bigint oracle work, VERDICT r4
        item 5a), then one batched host probe of every queried bucket
        (sklstore.probe_np). Returns a list of counts (mod 256) or None
        per query k-mer."""
        from brisk_tpu.index import keying
        p = self.params
        kmers = list(kmers)
        if not kmers:
            return []
        for s in kmers:
            if len(s) != p.k:
                raise ValueError(f"need a {p.k}-mer, got {len(s)} bases")
        buckets, cols = keying.key_batch(keying.strs_to_codes(kmers),
                                         p.m, p.b)
        self._ensure_final()
        if self._host_cache is None:  # one transfer, reused per get
            self._host_cache = sklstore.host_cache(self.skl)
        found, vals = sklstore.probe_np(self._host_cache, buckets, cols,
                                        p.k, p.m, p.b,
                                        segments=self._skl_segments)
        return [int(v) % 256 if f else None
                for f, v in zip(found.tolist(), vals.tolist())]

    def query_file(self, path: str) -> int:
        """Sum of stored counts over every k-mer emission of a query FASTA
        (reference query_fasta, counter.cpp:314-346).

        Round-4 path: the query file is enumerated into a TEMPORARY
        (un-finalized) row arena through the exact insert pipeline — so
        every already-compiled executable is reused — and resolved with
        ONE sort-merge join against the finalized index
        (sklstore.query_join_total). The old per-batch binary search was
        a 27-step gather per batch."""
        p = self.params
        self._ensure_final()
        qbr = Brisk(p, batch=self.batch, window=self.window,
                    stack=self.stack)
        qbr.insert_file(path)
        box = [qbr.skl]  # ownership moves to the join (HBM headroom)
        qbr.skl = None
        del qbr
        return sklstore.query_join_total(self.skl, box, p.k, p.m, p.b)

    # -- enumeration -------------------------------------------------------

    def items(self) -> Iterator[Tuple[int, int]]:
        """(kmer_value, count mod 256) per stored entry — Brisk::next
        (Brisk.hpp:166-172) as an iterator. Entries with the same k-mer
        value under different minimizer keys appear separately, exactly as
        the reference's cursor visits them."""
        kmers, counts, _ = readout.entries(self._expanded_view(),
                                           self.params)
        for kv, c in zip(kmers, counts):
            yield int(kv), int(c) % 256

    def counts_dict(self) -> dict:
        agg = {}
        for kv, c in self.items():
            agg[kv] = (agg.get(kv, 0) + c) % 256
        return agg

    # -- maintenance -------------------------------------------------------

    def stats(self) -> dict:
        p = self.params
        self._ensure_final()
        n_rows = int(self.skl.n_rows)
        nk = int(self.skl.n_fin_kmers)
        # EXACT distinct count via a device key sort (segment/chunk-local
        # consolidation leaves split counts, so count_nonzero(data) would
        # overcount; this runs on demand, off the ingest hot path)
        n_live = sklstore.distinct_count(self.skl, p.k, p.m, p.b)
        buckets = sklstore.fetch_rows(self.skl.bucket, 0, n_rows)
        sizes = sklstore.fetch_rows(self.skl.meta, 0, n_rows) & 0xFF
        if n_rows:
            nb_buckets = int(len(np.unique(buckets)))
            per_bucket = np.bincount(buckets, weights=sizes)
            largest = int(per_bucket.max())
        else:
            nb_buckets = largest = 0
        nw = self.skl.nucs.shape[0]
        s_max = sklstore.skl_dims(p.k, p.m, p.b)[1]
        resident = n_rows * (8 + 4 * nw) + n_rows * s_max
        return dict(nb_buckets=nb_buckets, nb_kmers=n_live,
                    nb_superkmers=self.n_superkmers,
                    nb_emitted=self.n_emitted,
                    nb_superkmer_rows=n_rows,
                    largest_bucket_entries=largest,
                    index_bytes=resident,
                    bytes_per_kmer=(resident / n_live) if n_live
                    else 0.0)

    def skl_stats(self) -> dict:
        self._ensure_final()
        p = self.params
        return sklstore.stats(self.skl, p.k, p.m, p.b)

    def reallocate(self) -> None:
        """Grow minimizer/bucket space: m += 2, b += 2, re-key every stored
        entry under the new minimizer decomposition (reference
        Brisk::reallocate, Brisk.hpp:202-224).

        Semantic deviation (documented, VERDICT r2 weak #8): b is CLAMPED
        at 15 while the reference grows it unboundedly. The flat routing
        tables here are sized 4^b (the reference pays the same 4^b
        `bucket_indexes` RSS, ~1.6 GB at b=15), so past b=15 only m keeps
        growing; bucket ids then hold fewer than m-b hash bases. Counts
        and lookups remain exact — only bucket granularity saturates."""
        from brisk_tpu.index import rekey
        new_params = Parameters(k=self.params.k, m=self.params.m + 2,
                                b=min(self.params.b + 2, 15))
        old = self._expanded_view()
        new_state = rekey.reindex(old, self.params, new_params)
        # super-k-mer grouping is invalid under the new (m, b); rebuild
        # one size-1 row per entry (the reference's reallocate, walking
        # its cursor in bucket order, likewise loses genome adjacency)
        self.skl = sklstore.from_entries(new_state, new_params.k,
                                         new_params.m, new_params.b)
        self._expanded = None
        self._rows_ub = int(self.skl.n_rows)
        # from_entries emits rows in packed-key order = bucket-major
        self._skl_segments = [(0, int(self.skl.n_fin_rows))]
        self._host_cache = None
        self.params = new_params

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Native checkpoint: the exact array state + params."""
        self._ensure_final()
        extra = dict(
            skl_bucket=np.asarray(self.skl.bucket),
            skl_meta=np.asarray(self.skl.meta),
            skl_nucs=np.asarray(self.skl.nucs),
            skl_data=np.asarray(self.skl.data),
            skl_offs=np.asarray(self.skl.offs),
            skl_n=np.array([int(self.skl.n_rows),
                            int(self.skl.n_fin_rows),
                            int(self.skl.n_fin_kmers)]),
            skl_segments=np.asarray(self._skl_segments,
                                    dtype=np.int64).reshape(-1, 2))
        np.savez_compressed(
            path,
            k=self.params.k, m=self.params.m, b=self.params.b,
            n_emitted=self.n_emitted, n_superkmers=self.n_superkmers,
            **extra)

    @classmethod
    def load(cls, path: str, batch: int = 512, window: int = 512
             ) -> "Brisk":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        if "skl_bucket" not in z:
            raise ValueError("not a super-k-mer-arena checkpoint (the "
                             "round-1/2 packed format was removed; "
                             "re-export via KFF)")
        self = cls(params, batch=batch, window=window)
        _, _, _, nw_now = sklstore.skl_dims(params.k, params.m, params.b)
        if z["skl_nucs"].shape[0] != nw_now:
            raise ValueError(
                "checkpoint row format mismatch (different "
                "SKL_SIZE_CAP build); re-export via KFF")
        nr, nfr, nfk = (int(x) for x in z["skl_n"])
        self.skl = sklstore.SklState(
            bucket=jnp.asarray(z["skl_bucket"]),
            meta=jnp.asarray(z["skl_meta"]),
            nucs=jnp.asarray(z["skl_nucs"]),
            data=jnp.asarray(z["skl_data"]),
            offs=jnp.asarray(z["skl_offs"]),
            n_rows=jnp.int32(nr), n_fin_rows=jnp.int32(nfr),
            n_fin_kmers=jnp.int32(nfk))
        self._rows_ub = nr
        if "skl_segments" in z:
            self._skl_segments = [tuple(int(x) for x in row)
                                  for row in z["skl_segments"]]
        elif nfr:
            self._skl_segments = [(0, nfr)]
        self.n_emitted = int(z["n_emitted"])
        self.n_superkmers = int(z["n_superkmers"])
        return self
