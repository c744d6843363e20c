"""Damped, equilibrated Cholesky solve: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Computes x = -(H + lam I)^-1 g exactly as
``triangulation_in_deformable_scenes_tpu/ops/lm.py:43-60`` does (Jacobi
equilibration, Cholesky, one refinement step against the unfactored A). The
kernel (``csrc/damped_cholesky.cu``) replaces the TPU kernel
``ops/pallas_cholesky.py:248 damped_solve_pallas``; its source states its
bound and design.

- ``damped_solve_cuda`` launches the kernel on CUDA tensors and raises on
  anything else, also when the card refuses the cooperative launch.
  ``LAUNCHES`` counts its calls: one solve is one CUDA launch.
- ``solve_damped_cholesky_plain`` is the same formula in torch
  (``cholesky_ex`` + ``cholesky_solve``). It returns NaN where the
  factorization fails, as ``jax.scipy.linalg.cho_factor`` does, so that LM
  rejects the trial instead of raising. It is the CPU path and the oracle
  the kernel is held against; nothing calls it for a CUDA tensor on the
  main path.

The kernel is built on first use with every other source of ``csrc/``
(``ops/_nvcc.py``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..precision import TINY
from . import _nvcc

# Launches of the kernel (one cooperative CUDA launch per solve), in all and
# by system dim, read by chip_smoke.py to show that the main path ran
# through the kernel.
LAUNCHES = 0
LAUNCHES_BY_DIM = collections.Counter()

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load()
        vp = ctypes.c_void_p
        lib.tids_damped_solve.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp]
        lib.tids_damped_solve.restype = ctypes.c_int
        lib.tids_damped_solve_pad.argtypes = [ctypes.c_int]
        lib.tids_damped_solve_pad.restype = ctypes.c_int
        lib.tids_damped_solve_grid.argtypes = [ctypes.c_int]
        lib.tids_damped_solve_grid.restype = ctypes.c_int
        lib.tids_damped_solve_timed.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.tids_damped_solve_timed.restype = ctypes.c_int
        _lib = lib
    return _lib


def damped_solve_cuda(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """x = -(H + lam I)^-1 g by the CUDA kernel; H [n, n] and g [n] f32 on
    the card, lam a float or a one-element tensor. Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
    if H.device.type != "cuda" or g.device != H.device:
        raise ValueError("damped_solve_cuda takes H and g on one CUDA device")
    if H.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("damped_solve_cuda takes float32 H and g")
    n = H.shape[0]
    if H.ndim != 2 or H.shape[1] != n or g.shape != (n,):
        raise ValueError(f"shapes H {tuple(H.shape)} and g {tuple(g.shape)} do not form one system")
    lib = _load()
    H = H.contiguous()
    g = g.contiguous()
    lam_t = _nvcc.lam_tensor(lam, H)
    npad = lib.tids_damped_solve_pad(n)
    opts = dict(dtype=torch.float32, device=H.device)
    x = torch.empty(n, **opts)
    L = torch.empty(npad * npad, **opts)
    Linv = torch.empty(npad * 32, **opts)
    vecs = torch.empty(4, npad, **opts)  # s, b, y, x0
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = lib.tids_damped_solve(
        H.data_ptr(), g.data_ptr(), lam_t.data_ptr(), x.data_ptr(), n,
        L.data_ptr(), Linv.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr(), vecs[3].data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"damped-Cholesky kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DIM[n] += 1
    return x


def solve_damped_cholesky_plain(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """Plain torch version of the kernel (``lm.py:43-60``); NaN on a failed
    factorization."""
    n = H.shape[0]
    A = H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=TINY))
    As = A * s[:, None] * s[None, :]
    Lf, info = torch.linalg.cholesky_ex(As)
    Lf = torch.where(info != 0, torch.full_like(Lf, float("nan")), Lf)

    def solve(rhs):
        return s * torch.cholesky_solve((rhs * s)[:, None], Lf)[:, 0]

    x = solve(-g)
    return x + solve(-g - A @ x)
