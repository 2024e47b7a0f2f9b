"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

At first use on the card, every source is compiled with ``nvcc`` for
Hopper (``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per
source, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. Nothing is
compiled or imported at module import, so ``import repro_torch`` works on
a host with no CUDA toolkit.

The library lands in ``build/repro_torch/`` at the repository root (an
ignored directory) under a name carrying a hash of the sources and the
flags, so a stale build is never loaded. ``nvcc`` is looked up on
``PATH``, then under ``$CUDA_HOME/bin``, then at
``/usr/local/cuda/bin/nvcc``; a missing compiler raises.

``launch`` is the one place a kernel is launched: it calls the C entry,
raises on a non-zero ``cudaGetLastError()``, and counts the launch in
``LAUNCHES`` (plain ints, keyed by entry name). The entries are looked
up and typed once, when the library loads (``bind``).
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
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argument types; every entry returns cudaGetLastError() as int.
# Byte lengths of the matrix entries are 64-bit: a batched launch over
# 64 MiB blocks holds more than 2^31 bytes.
ENTRIES = {
    # csrc/ragged_tiles.cu (K1-K4): mc, data, out, C, K, TN, stream
    "ragged_gf256_tiles": (_P, _P, _P, _I, _I, _I, _P),
    "ragged_xor_tiles": (_P, _P, _I, _I, _I, _P),
    "ragged_gf256_encode_tiles": (_P, _P, _P, _I, _I, _I, _P),
    "ragged_xor_encode_tiles": (_P, _P, _I, _I, _I, _P),
    # csrc/gf_matmul_xor.cu (K5-K7): [mc,] data, out, [B,] M/T, [K,] N,
    # block_n, stream
    "gf256_matmul_planes": (_P, _P, _P, _I, _I, _L, _I, _P),
    "gf256_matmul_planes_batched": (_P, _P, _P, _I, _I, _I, _L, _I, _P),
    "xor_parity": (_P, _P, _I, _L, _I, _P),
    "xor_parity_batched": (_P, _P, _I, _I, _L, _I, _P),
    # csrc/selective_scan.cu (K8): da, dbu, cm, h0 (nullable), y,
    # h_last (nullable), B, S, D, N, then selective_scan.scan_plan's body,
    # stages and grid x; stream
    "selective_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}
LAUNCHES: dict[str, int] = {name: 0 for name in ENTRIES}

_lib: ctypes.CDLL | None = None
# C entry -> its ctypes function, argtypes set: resolved once, when the
# library loads, so a launch takes no lock and looks nothing up
_fns: dict | None = None
_lock = threading.Lock()
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or at "
        "/usr/local/cuda/bin/nvcc: the CUDA kernels cannot be built"
    )


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libragged_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library with their hash exists: one
    ``nvcc -c`` per source, all running at once, then one link. The
    output is written to a temporary name and renamed into place, so a
    concurrent process never loads a half-written file."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, f"{src.stem}.o") for src in sources()]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [src.name for src, proc in zip(sources(), procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = os.path.join(objdir, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def bind(lib) -> dict:
    """The C entries of ``lib`` (a loaded ``ctypes.CDLL``) by name, with
    their argument and return types set, and its error-string helper."""
    fns = {}
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    fn = lib.ragged_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    fns["ragged_error_string"] = fn
    return fns


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and bound at first call."""
    global _lib, _fns
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _fns = bind(lib)
            _lib = lib
        return _lib


def _bound() -> dict:
    library()
    return _fns


def launch(name: str, *args) -> None:
    """Launch C entry ``name`` and count it; raise if CUDA refused it."""
    fns = _fns or _bound()
    rc = fns[name](*args)
    if rc != 0:
        msg = fns["ragged_error_string"](rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
