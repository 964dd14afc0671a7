"""Multi-host distributed insert: 2 jax.distributed processes x 4
virtual CPU devices on localhost, exact count parity vs the oracle
(SURVEY §5.8 / VERDICT r1 item 6). The same code path is meant for
several GPU hosts — only the coordinator address and device counts
change; it has not run on GPUs yet (ROADMAP D8)."""
import json
import os
import random
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_count_parity(tmp_path):
    port = free_port()
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "multihost_worker.py"),
         str(port), str(i), "2", outs[i]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    results = [json.load(open(o)) for o in outs]
    # shards partition 0..7 across the two processes
    all_shards = sorted(results[0]["shards"] + results[1]["shards"])
    assert all_shards == list(range(8))

    agg = {}
    for r in results:
        for kv, c in r["counts"].items():
            agg[int(kv)] = (agg.get(int(kv), 0) + c) % 256

    # oracle over the same deterministic record stream
    from brisk_tpu.oracle import pyref
    k, m = 31, 11
    rng = random.Random(97)
    records = ["".join(rng.choice("ACGT") for _ in range(rng.randint(k, 400)))
               for _ in range(24)]
    exp = {}
    dede = pyref.DecyclingSet(m)
    for seq in records:
        if len(seq) >= k:
            pyref.count_sequence(exp, seq, k, m, dede)
    assert results[0]["n_emitted"] == sum(len(s) - k + 1 for s in records)
    assert results[1]["n_emitted"] == results[0]["n_emitted"]
    assert agg == exp

    # the multi-host checkpoint (one file per process, shared prefix)
    # reassembles on a single "host" with the same global counts
    from brisk_tpu.parallel.facade import ShardedBrisk
    sb = ShardedBrisk.load_multihost_checkpoint(str(tmp_path / "ckpt"),
                                                n_devices=8)
    agg2 = {}
    for kv, c in sb.items():
        agg2[kv] = (agg2.get(kv, 0) + c) % 256
    agg2 = {kv: c for kv, c in agg2.items() if c}
    assert agg2 == exp
