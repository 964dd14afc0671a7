"""Capture a jax.profiler trace of the fused insert program + finalize
(the device-side equivalent of the reference's chrono stats,
counter.cpp:375-404).

Usage:  python scripts/trace_insert.py [out_dir]
Writes a TensorBoard/Perfetto-loadable trace under out_dir (default
chiprun_out/trace_insert inside the checkout) and prints the per-stage
wall clocks it measured, each ended by jax.block_until_ready.
"""
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np

import brisk_tpu
from brisk_tpu.index import pipeline, sklstore
from brisk_tpu.io import windows


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "chiprun_out", "trace_insert")
    brisk_tpu.enable_persistent_cache()
    dev = jax.devices()[0]
    k, m, b = 31, 11, 8
    B, W, S = 2048, 512, 8
    row_cap = max(16, W // 4)
    packer = windows.WindowPacker(k, m, batch=B, l_out=W)
    rng = np.random.default_rng(7)
    rec = rng.integers(0, 4, 8_000_000, dtype=np.uint8)
    fl = next(packer.pack_flat(iter([rec]), S))
    st = (jnp.asarray(fl.chunk4),
          jnp.asarray(fl.valid_start.reshape(S, B)),
          jnp.asarray(fl.valid_end.reshape(S, B)))
    _, _, _, nw = sklstore.skl_dims(k, m, b)

    def flush():
        o = pipeline.insert_flat_sklnative(
            sklstore.empty(1 << 23, 1 << 14, nw), st[0], st[1], st[2],
            pipeline.zero_chain(), k=k, m=m, b=b, row_cap=row_cap,
            l_buf=packer.l_buf, useful=packer.useful)
        return jax.block_until_ready(o[0])

    # compile both programs outside the trace (same shapes as inside)
    jax.block_until_ready(sklstore.finalize_device(flush(), k, m, b))
    with jax.profiler.trace(out):
        t0 = time.perf_counter()
        skl = flush()
        t1 = time.perf_counter()
        skl = sklstore.finalize_device(skl, k, m, b)
        jax.block_until_ready(skl)
        t2 = time.perf_counter()
    print(f"trace written to {out}")
    print(f"insert flush: {t1 - t0:.6f} s   finalize: {t2 - t1:.6f} s   "
          f"[{dev.platform} {dev.device_kind}]")


if __name__ == "__main__":
    main()
