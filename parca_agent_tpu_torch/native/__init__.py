"""Host C++ of the port, shipped as source and built at first use.

``vecenc.cc`` holds the host row hash behind ops/hashing.py and the
varint and ragged-copy passes behind pprof/vec.py; ``sampler.cc`` is the
perf_event ring drainer behind capture/live.py. Each is compiled by g++
(invoked directly) into ``parca_agent_tpu_torch/build/`` (listed in
.gitignore) as ``lib<name>-<digest>.so``, where the digest covers the
source and the flags, so an edited source is never served from a stale
build. The compile writes a temporary file that is renamed into place
under an exclusive lock on a file beside it, so processes that build the
same library at once leave one whole library. A failed build or load
raises, with the compiler's output: there is no numpy fallback.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build"
CXX = "g++"
CXXFLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_U32 = ctypes.c_uint32
_LONG = ctypes.c_long
_INT = ctypes.c_int
_U64 = ctypes.c_uint64
# C signatures of every entry point, by source: name -> (argtypes, restype).
SIGNATURES = {
    "vecenc": {
        "pa_varint_lens": ([_P, _I64, _P], None),
        "pa_put_varints": ([_P, _I64, _P, _P, _I64], _I64),
        "pa_put_varints_padded": ([_P, _I64, _P, _P, _I64, _I32], _I64),
        "pa_row_hash": ([_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _P, _I64,
                         _P], _I64),
        "pa_ragged_copy": ([_P, _I64, _P, _I64, _P, _P, _P, _I64], _I64),
    },
    "sampler": {
        "pa_sampler_create2": ([_INT, _INT, _U32], _P),
        "pa_sampler_n_cpus": ([_P], _INT),
        "pa_sampler_lost": ([_P], _U64),
        "pa_sampler_truncated": ([_P], _U64),
        "pa_sampler_start": ([_P], _INT),
        "pa_sampler_stop": ([_P], _INT),
        "pa_sampler_drain": ([_P, _P, _LONG], _LONG),
        "pa_sampler_drain_dedup": ([_P, _P, _LONG], _LONG),
        "pa_sampler_drain_dedup2": ([_P, _P, _LONG], _LONG),
        "pa_sampler_dedup_hits": ([_P], _U64),
        "pa_sampler_dedup_overflow": ([_P], _U64),
        "pa_sampler_set_hash": ([_P, _P, _LONG, _P, _INT, _LONG], _INT),
        "pa_sampler_destroy": ([_P], None),
        "pa_decode_v1_count": ([_P, _LONG, _LONG], _LONG),
        "pa_decode_v1": ([_P, _LONG, _P, _P, _P, _P, _P, _LONG, _LONG],
                         _LONG),
        "pa_decode_v1d_count": ([_P, _LONG, _LONG], _LONG),
        "pa_decode_v1d": ([_P, _LONG, _P, _P, _P, _P, _P, _P, _LONG, _LONG],
                          _LONG),
        "pa_decode_v1h_count": ([_P, _LONG, _LONG], _LONG),
        "pa_decode_v1h": ([_P, _LONG, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _LONG, _LONG], _LONG),
        "pa_stack_hash": ([_P, _LONG, _P, _LONG, _U32, _P, _LONG, _P, _LONG,
                           _LONG, _P], _INT),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the build of ``<name>.cc`` with the current flags lives."""
    src = SRC_DIR / f"{name}.cc"
    digest = hashlib.sha1(src.read_bytes() + " ".join(
        (CXX,) + CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def ensure_built(name: str) -> Path:
    """The path of ``<name>.cc``'s library, compiled first if it has no
    current build. Raises RuntimeError with the compiler's output when
    the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        # One build at a time; a process that waited here finds the
        # library its peer just renamed into place.
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(
                [CXX, *CXXFLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cc")],
                capture_output=True, text=True, timeout=600)
        except OSError as e:
            raise RuntimeError(f"native build of {name}.cc failed: "
                               f"cannot run {CXX}: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build of {name}.cc failed "
                               f"({CXX} exit {r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cc``, built first if needed, with
    every entry point of SIGNATURES typed. A failed build or load raises
    (and is tried again at the next call)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(ensure_built(name)), use_errno=True)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return lib
