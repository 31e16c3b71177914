"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc for sm_90a into its own shared
library with a plain C interface under ``libsplinter_tpu_torch/build/``
(a directory .gitignore lists) at first use, and loads through ctypes.
The C functions launch on the stream they are handed and return the
CUDA error code of the launch; the wrappers in ops/ raise on a non-zero
code.  Nothing here runs at import: the CPU tests import every module
of the package on a machine with no nvcc.

Launch counts: every wrapper bumps LAUNCHES[name] where it launches
its kernel and nowhere else, so a run can show that its main path went
through the kernels (chip_smoke.py resets and reads them).
"""
from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# kernel name -> source file; each builds to build/libsptk_<name>.so
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "cosine_scores": "cosine_scores.cu",
    "fused_topk": "fused_topk.cu",
    "causal_fwd": "causal_fwd.cu",
    "paged_fwd": "paged_fwd.cu",
}
_HEADERS = ("common.cuh", "topk_tile.cuh", "attention.cuh",
            "attention_mma.cuh")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# SMs of the H100 the launch plans assume when not handed the card's
H100_SMS = 132

P, I32, I64, F32 = C.c_void_p, C.c_int, C.c_longlong, C.c_float

# exported C function -> argtypes (restype is int: the CUDA error code)
_SIGNATURES = {
    "flash_fwd": {
        "sptk_flash_fwd": [P, P, P, P, P, P, I32, I32, I32, I32, I32,
                           I64, I64, I64, I64, I64, I64, I64, I64, I64,
                           I64, I64, I64, F32, P],
    },
    "flash_bwd": {
        "sptk_flash_bwd": [P, P, P, P, P, P, P, P, P, P, P, I32, I32,
                           I32, I32, I32, C.POINTER(I64), F32, P],
    },
    "cosine_scores": {
        "sptk_cosine_scores": [P, I64, I32, P, I32, P, P, P, I32, I32, I32,
                               P],
    },
    "fused_topk": {
        "sptk_fused_topk": [P, I64, I32, P, I32, P, P, I32, I32, I32, I32,
                            P, P, P, P, P, I32, P],
    },
    "causal_fwd": {
        "sptk_causal_fwd": [P, P, P, P, P, I32, I32, I32, I32, I32, I32,
                            I32, I32, I64, I64, I64, I64, I64, I64, I64,
                            I64, I64, I64, I64, I64, F32, P],
    },
    "paged_fwd": {
        "sptk_paged_fwd": [P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32,
                           I32, I32, I32, I32, I32, I32, I64, I64, I64, I64,
                           I64, I64, F32, P],
    },
}


class LaunchCounts(dict):
    """Kernel name -> launches since the last reset()."""

    def __init__(self):
        super().__init__(dict.fromkeys(SOURCES, 0))

    def bump(self, name: str) -> None:
        self[name] += 1

    def reset(self) -> None:
        for name in self:
            self[name] = 0

    def heartbeat_fields(self) -> dict:
        """The counts as heartbeat fields, kernel_<name>."""
        return {f"kernel_{name}": n for name, n in self.items()}


LAUNCHES = LaunchCounts()

_libs: dict[str, C.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The nvcc binary: $NVCC, then PATH, then PyTorch's CUDA_HOME."""
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if cand:
        return cand
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put "
                       "nvcc on PATH")


def library_path(name: str) -> Path:
    return BUILD / f"libsptk_{name}.so"


def _stale(name: str) -> bool:
    so = library_path(name)
    if not so.exists():
        return True
    built = so.stat().st_mtime
    srcs = [CSRC / SOURCES[name]] + [CSRC / h for h in _HEADERS]
    return any(p.exists() and p.stat().st_mtime > built for p in srcs)


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-lineinfo", "-o", str(out),
           str(CSRC / SOURCES[name])]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build(names=None, *, verbose: bool = False,
          force: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all stale ones), one nvcc
    process per source, all started together.  Returns
    {name: {"seconds": wall, "log": nvcc's stderr}} for each library
    built; raises RuntimeError with nvcc's output when one fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        # build to a private name, then rename: a concurrent loader
        # never sees a half-written library
        tmp = BUILD / f".libsptk_{name}.{os.getpid()}.so"
        procs[name] = (tmp, subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out: dict[str, dict] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def lib(name: str) -> C.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    with _lock:
        got = _libs.get(name)
        if got is not None:
            return got
        if _stale(name):
            build([name])
        got = C.CDLL(str(library_path(name)))
        for fn, args in _SIGNATURES[name].items():
            f = getattr(got, fn)
            f.argtypes = args
            f.restype = C.c_int
        got.sptk_error_string.argtypes = [C.c_int]
        got.sptk_error_string.restype = C.c_char_p
        _libs[name] = got
        return got


def launch(name: str, fn: str, *args) -> None:
    """Call one exported launcher of kernel `name`; raise on a non-zero
    CUDA error code, else count the launch."""
    so = lib(name)
    rc = getattr(so, fn)(*args)
    if rc != 0:
        msg = so.sptk_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
    LAUNCHES.bump(name)


def int64_array(values) -> C.Array:
    """A host array of int64 for a ``POINTER(c_longlong)`` argument
    (the C side reads it before it returns)."""
    return (C.c_longlong * len(values))(*values)


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
