"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles on its own with one ``nvcc`` call into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), all sources started together.  The
libraries land in ``build/repro_torch/`` at the repository root, named
by a hash of their source and flags so a stale build is never loaded,
and are bound with ``ctypes``.

Each C entry point takes device pointers, plain scalars and the CUDA
stream last, launches on that stream, and returns ``cudaGetLastError()``;
``launch`` raises if it is not 0.  ``launch`` also counts the launches
per kernel, so a run can show that its main path went through the
kernels (``launch_counts`` / ``reset_launch_counts``).

Nothing here runs at import time: the tests import every module on a
machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cluster_scatter", "game_bestresponse", "game_bestresponse_csr",
           "game_gs", "ell_spmv", "transform_scan", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}
_launches: Counter = Counter()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no current build, one ``nvcc`` per
    source, all in parallel.  Returns ``{name: {"seconds", "ptxas",
    "cached"}}`` and raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": log.strip(), "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _arg(x):
    import torch
    if x is None:                       # an optional input left out
        return ctypes.c_void_p(None)
    if isinstance(x, torch.Tensor):
        return ctypes.c_void_p(x.data_ptr())
    if isinstance(x, bool):
        return ctypes.c_int(int(x))
    if isinstance(x, int):
        return ctypes.c_int(x)
    if isinstance(x, float):
        return ctypes.c_float(x)        # rounds to f32, as jnp.float32 does
    raise TypeError(f"unsupported kernel argument {type(x).__name__}")


def launch(lib_name: str, fn_name: str, *args) -> None:
    """Call ``fn_name`` of ``lib_name`` on PyTorch's current stream and
    count one launch of that kernel.  Tensors pass as device pointers, None as
    a null pointer, Python ints as C ints, floats as C floats."""
    import torch
    cargs = [_arg(a) for a in args]
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    sig = (lib_name, fn_name, *(type(a) for a in cargs))
    fn = _fns.get(sig)
    if fn is None:
        fn = getattr(_lib(lib_name), fn_name)
        fn.argtypes = list(sig[2:])
        fn.restype = ctypes.c_int
        _fns[sig] = fn
    err = fn(*cargs)
    if err != 0:
        msg = _lib(lib_name).repro_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")
    _launches[lib_name] += 1


def launch_counts() -> dict:
    """Launches per kernel (keyed by source name) since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def require_cuda(*tensors) -> None:
    """The wrappers' device/contiguity check for the kernel route."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel inputs must all lie on the same CUDA "
                             "device (CPU inputs take the plain version)")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
