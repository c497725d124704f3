"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of the
source, of every header of ``csrc/`` (``*.cuh``) and of the flags (the
``-D`` defines a wrapper passes included), so an edited source or header
is rebuilt and an unchanged one is reused.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them together.

Nothing here runs at import: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# -fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# like the reference's separate multiply and add (the term-bag kernel
# also spells its arithmetic with __fmul_rn/__fadd_rn).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{key}={value}"
                              for key, value in sorted(defines.items()))


def library_path(name: str, defines=None) -> Path:
    """Where ``csrc/<name>.cu`` builds to with the macros ``defines``
    ({name: value}; hash of the source, the headers and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(defines or {})).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names, defines=None) -> dict[str, str]:
    """Build every library of ``names`` that is missing, one ``nvcc``
    each, all started together; ``defines`` maps a name to its macros.
    Returns {name: compiler log} for the libraries built in this call
    (``-Xptxas=-v``: registers, shared memory, spills).  Raises with the
    compiler's output on failure."""
    defines = defines or {}
    logs = build_variants([(name, defines.get(name)) for name in names])
    return {name: log for (name, _d), log in logs.items()}


def build_variants(variants) -> dict[tuple, str]:
    """``build`` over (name, macros) pairs, so that one source may be
    built with several sets of macros at once (the sweeps' variants).
    Returns {(name, the macros' sorted items): compiler log}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defs in variants:
        out = library_path(name, defs)
        key = (name, tuple(sorted((defs or {}).items())))
        if out.exists() or key in procs:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{len(procs)}.tmp")
        procs[key] = (subprocess.Popen(
            [nvcc_path(), *_flags(defs or {}), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {}
    failed = []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[key] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {key[0]}.cu {dict(key[1])} exited "
                          f"{proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str, declare, defines=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with the macros
    ``defines``, built on first use.  ``declare(lib)`` sets the kernels'
    ``argtypes``/``restype`` once, at load; ``error_string`` is declared
    here."""
    key = (name, tuple(sorted((defines or {}).items())))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([name], {name: defines})
            lib = ctypes.CDLL(str(library_path(name, defines)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[key] = lib
        return lib


def loaded() -> dict[str, int]:
    """{source name: libraries of it loaded in this process} (one per set
    of macros): what the residency ledger's compile registry counts."""
    with _lock:
        keys = list(_libs)
    out: dict[str, int] = {}
    for name, _defines in keys:
        out[name] = out.get(name, 0) + 1
    return out


def count(wrapper, n: int = 1, attr: str = "launches") -> None:
    """Add ``n`` to a wrapper's counter (``wrapper.launches`` by default)
    under one lock: wrappers launch from many threads at once (the
    engine's threadpool, continuous-batch leaders)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


class KernelLaunchError(RuntimeError):
    """A hand kernel's launch returned a CUDA error.  It is the kernel's
    fault (its build, its launch shape, its code), not the device's:
    ``__device_fault__`` is False, so ``common/device_health.py``
    ``is_device_error`` does not match it and no caller demotes the
    request to a path that does the kernel's work elsewhere; it reaches
    the caller."""

    __device_fault__ = False


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``KernelLaunchError`` if a launch returned a CUDA error code
    (every library exports ``error_string`` for the message)."""
    if rc != 0:
        msg = lib.error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc}: {msg}")
