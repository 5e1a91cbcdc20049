"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, at first use, into ``parca_agent_tpu_torch/build/``
(listed in .gitignore), and loaded with ctypes. The library's file name
carries a digest of its source, so an edited kernel is never served from
a stale build. A failed build raises: there is no fallback.

Nothing here runs at import time: this module is imported on hosts that
have no nvcc and no card (the CPU tests), where no kernel is ever built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_ERR = ([ctypes.c_int], ctypes.c_char_p)
# C signatures of every entry point, by source: name -> (argtypes, restype).
SIGNATURES = {
    "feed_probe": {
        "pa_batch_probe": ([_P, _I64, _P, _P, _P, _P, _I64, _P],
                           ctypes.c_int),
        "pa_feed_accumulate": ([_P, _I64, _P, _I64, _P, _I64, _I64, _P, _P,
                                _P, _P, _P, _I64, _P], ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "loc_table": {
        "pa_loc_table": ([_P, _P, _P, _P, _U32, _U32, _U32, _U32, _I64,
                          _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
                         ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "close_pack": {
        "pa_close_scratch_words": ([_I64], ctypes.c_int64),
        "pa_close_pack": ([_P, _I64, _I64, _I64, _I64, _P, _P, _P],
                          ctypes.c_int),
        "pa_close_pack_delta": ([_P, _P, _I64, _I64, _I64, _I64, _I64, _P,
                                 _P, _P], ctypes.c_int),
        "pa_close_pack_sharded": ([_P, _I64, _I64, _I64, _I64, _I64, _I64,
                                   _P, _P, _P], ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "sharded_feed": {
        "pa_sharded_feed_max_shards": ([], ctypes.c_int64),
        "pa_sharded_feed_scratch_words": ([_I64, _I64], ctypes.c_int64),
        "pa_sharded_feed": ([_P, _I64, _I64, _P, _I64, _P, _I64, _P, _P, _P,
                             _P], ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "row_hash": {
        "pa_row_hash": ([_P, _P, _P, _P, _P, _I64, _I64, _P, _U32, _U32, _P,
                         _P, _P], ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "sketch_build": {
        "pa_sketch_build": ([_P, _P, _P, _I64, _I64, _I64, _P, _I64, _I64,
                             *[_U32] * 8, _P, _I64, _U32, _I64, _P, _P],
                            ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
    "fleet_merge": {
        "pa_fleet_segment_scratch_words": ([_I64], ctypes.c_int64),
        "pa_fleet_segment": ([_P, _P, _I64, _P, _P, _P, _P, _P, _P],
                             ctypes.c_int),
        "pa_cuda_error_string": _ERR,
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of parca_agent_tpu_torch are built from csrc/ at "
        "first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(ARCH_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(source: Path, out: Path) -> list[str]:
    """nvcc's command line that builds `source` into the library `out`."""
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(source)]


def build(names=None) -> dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns each source's
    compiler output (ptxas register and shared-memory report); raises
    RuntimeError when any compile fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[name] = lib
        return lib


# The scratch of the kernels that run a single pass with decoupled
# look-back (close_pack, sharded_feed, fleet_merge): one per (source,
# device, stream, tag), zeroed once when it is created and replaced by a
# larger one (zeroed once too) when a call needs more words. The kernels'
# status records carry an epoch that the scratch holds itself, so it is
# never cleared between calls. Keyed by the stream, so calls on one
# scratch are in stream order and never overlap.
SCRATCH: dict = {}


def epoch_scratch(name: str, dev: torch.device, stream, words: int,
                  dtype: torch.dtype, tag=None) -> torch.Tensor:
    """The cached scratch of csrc/<name>.cu on `stream`: at least `words`
    elements of `dtype`, zeroed once, on `stream` (the current one)."""
    key = (name, dev.index, stream.cuda_stream, tag)
    buf = SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = SCRATCH[key] = torch.zeros(words, dtype=dtype, device=dev)
    return buf


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch reported a CUDA error (code != 0)."""
    if code != 0:
        msg = lib.pa_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"error {code} ({msg})")
