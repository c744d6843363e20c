"""Build of the port's CUDA kernels: every ``csrc/*.cu`` into one shared
library with a plain C interface, loaded with ctypes.

``build()`` compiles each source to an object with its own nvcc process (all
started together), links the objects into
``build/torch_kernels/libtids_kernels_<hash>.so`` at the root of the
checkout and returns that path; the hash covers every source and the flags,
so a changed source builds a new library and an unchanged one is not built
again. nvcc's output (``-Xptxas -v``: registers, shared memory and spills of
every kernel) is kept in ``BUILD_LOG``. ``load()`` builds on first use and
returns the one ``ctypes.CDLL``; each kernel's wrapper module declares the
argument types of its own entry points. ``lam_tensor`` puts a damping
value where a kernel reads it, on the device, so the caller never syncs.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_LOG = ""
_lib = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    """nvcc from PATH, else from the toolkit under $CUDA_HOME."""
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile ``csrc/*.cu`` if their library is missing; returns its path."""
    global BUILD_LOG
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    lib_path = os.path.join(BUILD_DIR, f"libtids_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o") for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(s)}\n{out}")
        if p.returncode != 0:
            failed.append(s)
    BUILD_LOG = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{BUILD_LOG}")
    tmp = f"{lib_path}.{tag}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    BUILD_LOG += proc.stdout + proc.stderr
    for o in objs:
        os.remove(o)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib_path}:\n{BUILD_LOG}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib


def stream_ptr(dev: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``dev``
    (``torch.cuda.current_stream(dev).cuda_stream``, without making a
    Stream object where torch offers the raw call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


def lam_tensor(lam, like: torch.Tensor) -> torch.Tensor:
    """``lam`` (a float or a one-element tensor) as a contiguous one-element
    tensor of ``like``'s dtype on ``like``'s device."""
    if isinstance(lam, torch.Tensor):
        if lam.numel() != 1:
            raise ValueError("lam must hold one value")
        return lam.to(device=like.device, dtype=like.dtype).reshape(1).contiguous()
    return torch.full((1,), float(lam), dtype=like.dtype, device=like.device)
