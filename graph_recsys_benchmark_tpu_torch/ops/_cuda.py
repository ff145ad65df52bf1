"""Build and bind the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<source>.cu`` compiles on its own (one nvcc process per source,
all started together) for ``sm_90a`` into ``_build/lib<source>-<hash>.so``,
where the hash covers the source, the shared headers and the flags, so a
stale library is never loaded.  Sources expose plain C entries
(``_SIGNATURES``) that launch on the stream they are given and return
``cudaGetLastError()``.

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
_L = ctypes.c_longlong
# C entry -> (source in csrc/, ctypes argtypes)
_SIGNATURES = {
    # device, table, bf16, round_p_first, adst, mhat, perm, ids, src, acc,
    # num_edges, num_rows, kz, n_ch, stride, slope, stream
    "gat_fwd": ("gat_fwd", [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                            _L, _I, _I, _I, _I, ctypes.c_float, _P]),
    # device, table, bf16, round_att_first, gtab, logden, adst, perm, ids,
    # dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slope, stream
    "gat_bwd": ("gat_bwd", [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _L, _I, _I, _I, _I, ctypes.c_float, _P]),
    # device, table, bf16, adst, perm, ids, src, m, num_edges, num_rows,
    # kz, slope, stream (K12-online, pass 1; pass 2 is gat_fwd)
    "gat_rowmax": ("gat_fwd", [_I, _P, _I, _P, _P, _P, _P, _P, _L, _I, _I,
                               ctypes.c_float, _P]),
    # device, table, bf16, gtab, logden, adst, perm, ids, src, ct, dadst,
    # num_edges, num_rows, kz, slope, stream (K13)
    "gat_bwd_glue": ("gat_bwd", [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _L, _I, _I, ctypes.c_float, _P]),
    # device, table, bf16, stat, perm, ids, dst, dpk, dadst, num_edges,
    # num_rows, kz, stride, slope, stream (K14)
    "gat_bwd_onepass": ("gat_bwd", [_I, _P, _I, _P, _P, _P, _P, _P, _P, _L,
                                    _I, _I, _I, ctypes.c_float, _P]),
    # device, rows, bf16, perm, ids, out, num_edges, num_rows, d, stride,
    # ld_in, ld_out, stream
    "scatter_add": ("segment", [_I, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]),
    # device, v, idx, out, num_edges, num_rows, row_bytes, stream
    "row_gather": ("segment", [_I, _P, _P, _P, _L, _I, _I, _P]),
    # device, alpha, dst, bounds, stats, num_edges, n_blocks, num_rows,
    # stream
    "softmax_stats": ("segment", [_I, _P, _P, _P, _P, _L, _I, _I, _P]),
    # device, table, bf16, adst, mhat, src, dst, bounds, acc, num_edges,
    # n_blocks, num_rows, kz, n_ch, piece_edges, slope, stream
    "stream_gat_fwd": ("stream_gat", [_I, _P, _I, _P, _P, _P, _P, _P, _P,
                                      _L, _I, _I, _I, _I, _I, ctypes.c_float, _P]),
    # device, table, bf16, stat, src, dst, bounds, dadst, num_edges,
    # n_blocks, num_rows, kz, n_ch, sstride, piece_edges, slope, stream
    "stream_gat_bwd_dst": ("stream_gat", [_I, _P, _I, _P, _P, _P, _P, _P,
                                          _L, _I, _I, _I, _I, _I, _I,
                                          ctypes.c_float, _P]),
    # device, table, bf16, stat, perm, src_sorted, dst, bounds, dpk,
    # num_edges, n_blocks, n_src, num_rows, kz, n_ch, sstride, piece_edges,
    # slope, stream
    "stream_gat_bwd_src": ("stream_gat", [_I, _P, _I, _P, _P, _P, _P, _P, _P,
                                          _L, _I, _I, _I, _I, _I, _I, _I,
                                          ctypes.c_float, _P]),
}
_SOURCES = tuple(sorted({src for src, _ in _SIGNATURES.values()}))

_lock = threading.Lock()
_libs: dict = {}  # source -> CDLL, kept alive for its functions
_fns: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build at first use and need the "
            "CUDA toolkit (nvcc on PATH or under /usr/local/cuda)"
        )
    return path


def _lib_path(name):
    """The library's path, hashed over its source, every header in csrc/
    (the sources share gat_common.cuh) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
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
        for name in _SOURCES:
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
    """The ctypes function of C entry `name`, its library built on first use."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            source, argtypes = _SIGNATURES[name]
            path = _lib_path(source)
            if not os.path.isfile(path):
                build_all()
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = ctypes.CDLL(path)
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return fn


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
    fn = load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(device.index, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
