"""Deterministic synthetic inputs for the tests, chip_smoke.py and
bench.py: seeded FASTA files, seeded super-k-mer span rows, and the name
of the card they run on.

Usage: python tests/make_synth_fasta.py <out.fa> <n_bases> [--reads L] [--seed S]

Default emits one long random contig; --reads L splits into records of
length L. A small fraction of N's is injected to exercise chunk splitting.
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(ROOT, ".smoke_data")  # gitignored


def write_synth(out: str, n_bases: int, read_len: int = 0,
                seed: int = 1234) -> None:
    n = n_bases
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    alphabet = np.frombuffer(b"ACTG", dtype=np.uint8)
    seq = alphabet[codes]
    # inject sparse N runs (~0.01%)
    n_ns = max(1, n // 10000)
    pos = rng.integers(0, n, size=n_ns)
    seq[pos] = ord("N")
    seq = seq.tobytes().decode()
    with open(out, "w") as f:
        if read_len:
            for i, j in enumerate(range(0, n, read_len)):
                f.write(f">r{i}\n{seq[j:j+read_len]}\n")
        else:
            f.write(">synth\n")
            for j in range(0, n, 80):
                f.write(seq[j:j + 80] + "\n")


def synth_fasta(n_bases: int, read_len: int, seed: int,
                data_dir: str = DATA_DIR) -> str:
    """Path of the seeded FASTA (write_synth), made once in data_dir."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"synth_{n_bases}_{read_len}_{seed}.fa")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        write_synth(tmp, n_bases=n_bases, read_len=read_len, seed=seed)
        os.replace(tmp, path)
    return path


def random_span(R: int, k: int, m: int, b: int, seed: int):
    """Seeded span rows that respect the arena's invariants: bucket below
    4^b or INVALID (dead, 15%), size in [1, s_max], plausible mini_idx.
    Returns device arrays (bucket, meta, nucs) and s_max."""
    import jax.numpy as jnp

    from brisk_tpu.index import sklstore
    cs, s_max, _, nw = sklstore.skl_dims(k, m, b)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 1 << (2 * b), R, dtype=np.uint32)
    bucket[rng.random(R) < 0.15] = 0xFFFFFFFF
    size = rng.integers(1, s_max + 1, R, dtype=np.uint32)
    mini = (size - 1) + rng.integers(0, cs - s_max + 1, R,
                                     dtype=np.uint32) + 3
    meta = (size & 0xFF) | ((mini & 0xFF) << 8)
    nucs = rng.integers(0, 1 << 32, (nw, R), dtype=np.uint32)
    return (jnp.asarray(bucket), jnp.asarray(meta.astype(np.uint32)),
            jnp.asarray(nucs), s_max)


def card_info() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main():
    out = sys.argv[1]
    n = int(sys.argv[2])
    read_len = 0
    seed = 1234
    args = sys.argv[3:]
    while args:
        a = args.pop(0)
        if a == "--reads":
            read_len = int(args.pop(0))
        elif a == "--seed":
            seed = int(args.pop(0))
    write_synth(out, n, read_len, seed)
    print(f"wrote {out}: {n} bases, reads={read_len or 'single contig'}")


if __name__ == "__main__":
    main()
