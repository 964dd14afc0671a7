"""Native (C++) host-side components, loaded via ctypes.

`load()` builds `fasta_codec.cpp` with g++ on first use into
`build/native/` inside the checkout (listed in .gitignore), for the
baseline CPU of the architecture and not `-march=native`: the checkout
may be copied to a host with another CPU. A failed build is reported on
stderr once, with the compiler's message, and the package falls back to
the pure-Python parser (correct, but orders of magnitude slower).
"""

import ctypes
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "fasta_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
SO_PATH = os.path.join(BUILD_DIR, "libbrisk_native.so")

_lib = None
_load_failed = False


def build_command(out: str) -> list:
    """g++ command line that builds the parser library at `out`."""
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC, "-lz",
            "-o", out]


def _build() -> None:
    """Compile to a private name, then rename into place: concurrent
    processes (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True,
                       text=True)
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Returns the native library, building it on first use; None if the
    build or load fails (callers fall back to Python)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if (not os.path.exists(SO_PATH)
                or os.path.getmtime(SO_PATH) < os.path.getmtime(SRC)):
            _build()
        lib = ctypes.CDLL(SO_PATH)
    except (OSError, subprocess.CalledProcessError) as e:
        _load_failed = True
        msg = getattr(e, "stderr", None) or str(e)
        print(f"brisk_tpu.native: building {SO_PATH} failed; using the "
              f"pure-Python FASTA parser.\n{msg}", file=sys.stderr)
        return None
    lib.brisk_fasta_parse.restype = ctypes.c_void_p
    lib.brisk_fasta_parse.argtypes = [ctypes.c_char_p]
    lib.brisk_fasta_n_chunks.restype = ctypes.c_uint64
    lib.brisk_fasta_n_chunks.argtypes = [ctypes.c_void_p]
    lib.brisk_fasta_n_codes.restype = ctypes.c_uint64
    lib.brisk_fasta_n_codes.argtypes = [ctypes.c_void_p]
    lib.brisk_fasta_codes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.brisk_fasta_codes.argtypes = [ctypes.c_void_p]
    lib.brisk_fasta_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.brisk_fasta_offsets.argtypes = [ctypes.c_void_p]
    lib.brisk_fasta_free.restype = None
    lib.brisk_fasta_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def parse_fasta_codes(path: str):
    """Parse a FASTA file natively: returns a list of numpy uint8 code
    arrays (one per cleaned chunk), or None if the native lib is
    unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    h = lib.brisk_fasta_parse(path.encode())
    if not h:
        raise IOError(f"native FASTA parse failed: {path}")
    try:
        n_codes = lib.brisk_fasta_n_codes(h)
        n_chunks = lib.brisk_fasta_n_chunks(h)
        codes = np.ctypeslib.as_array(lib.brisk_fasta_codes(h),
                                      shape=(n_codes,)).copy()
        offsets = np.ctypeslib.as_array(lib.brisk_fasta_offsets(h),
                                        shape=(n_chunks + 1,)).copy()
    finally:
        lib.brisk_fasta_free(h)
    return [codes[offsets[i]:offsets[i + 1]] for i in range(n_chunks)]
