"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, bound with :mod:`ctypes`.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch_kernels/lib<name>.so`` under the repository root, at first
use, and is rebuilt when its source is newer than the library. Nothing
includes PyTorch's headers, so a build takes seconds. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``--fmad=false`` — the kernels keep
the reference's rounding of every multiply and add (no contraction into
fused multiply-adds), so the float64 instantiations track the float64
oracles to the last few ulps.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: repository root (src/repro_torch/kernels -> three levels up)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}   # (library, symbol) -> typed ctypes function
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(names, *, verbose: bool = False) -> dict[str, str]:
    """Compile every stale source in ``names`` in parallel (one ``nvcc``
    each); returns each build's compiler output. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name) and not verbose:
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (tmp, subprocess.Popen(
            _command(name, tmp, verbose),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs: dict[str, str] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu`` with its C signature set, bound once
    per process: later calls are one dictionary lookup, with no lock and no
    signature to set again."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error code (``cudaGetLastError``
    right after the launches, as the C entry point reports it)."""
    if err != 0:
        fn = entry(name, f"{name}_error_string", [ctypes.c_int], ctypes.c_char_p)
        msg = fn(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
