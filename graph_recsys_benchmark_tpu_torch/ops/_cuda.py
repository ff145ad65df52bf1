"""Build and bind the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles on its own (one nvcc process per source,
all started together) for ``sm_90a`` into ``_build/lib<name>-<hash>.so``,
where the hash covers the source and the flags, so a stale library is never
loaded.  Sources expose a plain C entry of the same name that launches on
the stream it is given and returns ``cudaGetLastError()``.

Nothing here runs at import: the build happens when a CUDA tensor first
reaches a kernel wrapper (or when ``build_all`` is called), so the package
imports on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # device, table, bf16, round_p_first, adst, mhat, src, dst, acc,
    # num_edges, num_rows, kz, n_ch, slope, stream
    "gat_fwd": [_I, _P, _I, _I, _P, _P, _P, _P, _P,
                ctypes.c_longlong, _I, _I, _I, ctypes.c_float, _P],
    # device, table, bf16, round_att_first, gtab, logden, adst, src, dst,
    # dpk, dadst, num_edges, num_rows, kz, n_ch, slope, stream
    "gat_bwd": [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                ctypes.c_longlong, _I, _I, _I, ctypes.c_float, _P],
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build at first use and need the "
            "CUDA toolkit (nvcc on PATH or under /usr/local/cuda)"
        )
    return path


def _lib_path(name):
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all():
    """Compile every kernel source that has no up-to-date library, one nvcc
    per source, all started together.  Returns {name: nvcc's output} for the
    sources compiled by this call (the ``-Xptxas -v`` register and
    shared-memory report).  Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in _SIGNATURES:
            out = _lib_path(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out,
            )
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate(timeout=BUILD_TIMEOUT_S)[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name):
    """The ctypes library exposing C entry `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.isfile(path):
                build_all()
            lib = ctypes.CDLL(path)
            fn = getattr(lib, name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def require(t, name, dtype, shape, device):
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(name, device, *args):
    """Call C entry `name` on `device` and PyTorch's current stream there;
    raise if it reports a CUDA error."""
    fn = getattr(load(name), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(device.index, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
