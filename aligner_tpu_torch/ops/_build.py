"""Build and load the CUDA kernels under ``aligner_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain C interface, loaded with ctypes (no
PyTorch headers: a build takes seconds, not minutes).  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The build happens at first use, never at import; a failed build
raises.

Flags: ``sm_90a`` for Hopper, ``-fmad=false`` and no fast-math, because
the kernels are held bit-for-bit to the reference's IEEE arithmetic.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_OUT_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build


class KernelBuildFailure(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildFailure("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if not srcs:
        raise KernelBuildFailure(f"no CUDA sources under {_CSRC}")
    return srcs


def _so_path(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode())
            h.update(fh.read())
    return os.path.join(_OUT_DIR, f"aligner_kernels_{h.hexdigest()[:16]}.so")


def _run_nvcc(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    """Wait for every started nvcc; raise with the output of the first
    that failed."""
    failed = None
    for cmd, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = KernelBuildFailure(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed is not None:
        raise failed


def _compile(so: str, srcs: list[str]) -> None:
    os.makedirs(_OUT_DIR, exist_ok=True)
    # per-process temp names + atomic rename: concurrent build processes
    # never publish (or dlopen) a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(_OUT_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    tmp = f"{so}.{tag}"
    nvcc = _nvcc()
    try:
        procs = []
        for src, obj in zip(srcs, objs):
            cmd = [nvcc, *FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        _run_nvcc(procs)
        cmd = [nvcc, *FLAGS, "-shared", "-o", tmp, *objs]
        _run_nvcc([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.unlink(f)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        so = _so_path(srcs)
        t0 = time.perf_counter()
        if not os.path.exists(so):
            _compile(so, srcs)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _bind(lib)
        _LIB = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.dp_fill_launch.argtypes = [
        p, p, p, p, p, i64,  # qT, tT, qlen, tlen, matrix, matrix batch stride
        i32, i32, i32, i32,  # V, B, C, R8
        f64, f64,  # del, ext
        i32, i32, i32, i32, i32,  # is_f64, is_pwm, is_global, track_argmax, with_dirs
        p, p, p, p, p, p,  # colbuf, fmax, fy, fx, end, words
        i32, p,  # threads per block, stream
    ]
    lib.dp_fill_launch.restype = i32
    lib.device_walk_launch.argtypes = [
        p, i64, p, p,  # words, words per problem, sy, sx
        i32, i32, i32, i32,  # B, C, S, is_global
        p, p, p, p,  # steps, n, ey, ex
        i32, p,  # threads per block, stream
    ]
    lib.device_walk_launch.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def threads_for(batch: int, device) -> int:
    """Threads per block for one-thread-per-problem kernels: the largest
    of 128/64/32 that still gives every SM at least one block, so a small
    batch (the p-value's 4,999 problems) spreads over all SMs instead of
    piling onto a few."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for t in (128, 64):
        if -(-batch // t) >= sms:
            return t
    return 32
