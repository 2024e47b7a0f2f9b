"""zlib's crc32 at the host's memory rate: ``csrc/crc32_fold.c``.

The C routine folds the input with carry-less multiplies (PCLMULQDQ on
four 128-bit lanes, or VPCLMULQDQ on four 512-bit lanes where the CPU
has AVX-512) and gives the same integer as ``zlib.crc32`` at every
length and seed. zlib's own crc32 is a table loop bound by the CPU,
1.8-2.7 GB/s a thread; the fold reads 64 MiB at 5.5-9 GB/s on one
thread and at the memory's rate on a pool of them.

At first use the source is compiled with the host's C compiler (``cc``,
``gcc`` or ``clang`` on ``PATH``; no CUDA) into a shared library in
``build/repro_torch/`` at the repository root, under a name carrying a
hash of the source and the flags, and loaded with ``ctypes``, which
releases the GIL for the call, so pool threads hash in parallel. The
build runs once per process, under a lock, on the thread that first
asks. Where no compiler is found, the build fails, or the CPU lacks the
instructions, ``fold()`` is None and every digest goes through
``zlib.crc32``; inputs under ``FOLD_MIN_BYTES`` always do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import zlib

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "crc32_fold.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CFLAGS = ("-std=gnu11", "-O2", "-fPIC", "-shared")

# An input shorter than this goes through zlib: a ctypes call and the
# array's address cost 2.5-3 us, which zlib spends hashing 8-10 KiB.
FOLD_MIN_BYTES = 8 << 10

_lib: ctypes.CDLL | None = None
_best = 0  # the library's crc32_fold_level(): 0 means no fold on this CPU
_tried = False
_lock = threading.Lock()
build_error: str = ""  # why the library is not loaded, after a failed first use


def find_cc() -> str | None:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    return None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcrc32fold_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless a library with its hash exists. The
    output is written to a temporary name and renamed into place, so a
    concurrent process never loads a half-written file."""
    out = library_path()
    if out.exists():
        return out
    cc = find_cc()
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc or clang) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run([cc, *CFLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> None:
    global _lib, _best, build_error
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        build_error = str(exc)
        return
    for name in ("crc32_fold", "crc32_fold_at"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
        fn.restype = ctypes.c_uint32
    lib.crc32_fold_at.argtypes = [ctypes.c_int, *lib.crc32_fold.argtypes]
    lib.crc32_fold_level.argtypes = []
    lib.crc32_fold_level.restype = ctypes.c_int
    _best = lib.crc32_fold_level()
    _lib = lib


def library() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; None where it could
    not be built or loaded (``build_error`` says why)."""
    global _tried
    if not _tried:
        with _lock:
            if not _tried:
                _load()
                _tried = True
    return _lib


def fast_path() -> bool:
    """Whether digests of ``FOLD_MIN_BYTES`` and more take the fold here:
    the library loaded and its ``crc32_fold_level()`` is above 0."""
    return library() is not None and _best > 0


def fold():
    """The C ``crc32_fold(buf, len, crc)`` where the fast path runs, else None."""
    return library().crc32_fold if fast_path() else None


def folds(view: np.ndarray, fn) -> bool:
    """Whether ``crc32(view, fn)`` hashes ``view`` by the fold."""
    return fn is not None and view.nbytes >= FOLD_MIN_BYTES


def crc32(view: np.ndarray, fn) -> int:
    """zlib's crc32 of the flat uint8 ``view``: by ``fn`` (``fold()``'s
    entry) from ``FOLD_MIN_BYTES`` up, else by zlib."""
    return fn(view.ctypes.data, view.nbytes, 0) if folds(view, fn) else zlib.crc32(view)
