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
- ``damped_solve_batched_cuda`` solves a batch of systems of one dim (the
  serving path's ``vmap`` of the JAX contract, ``deformable.py:884`` there)
  in ONE launch of the same kernel, every member bit for bit the single
  launch's result. Both go through the kernel's batched entry (a single
  solve is a batch of one). ``LAUNCHES_BATCHED`` counts its calls, and
  ``LAUNCHES_BATCHED_BY_SHAPE`` by (batch, dim). While tracing is on,
  each launch of either is timed by CUDA events (``tracing.kernel``,
  family ``kernel1``).
- ``solve_damped_cholesky_plain`` is the same formula in torch
  (``cholesky_ex`` + ``cholesky_solve``). It returns NaN where the
  factorization fails, as ``jax.scipy.linalg.cho_factor`` does, so that LM
  rejects the trial instead of raising. It is the CPU path and the oracle
  the kernel is held against; nothing calls it for a CUDA tensor on the
  main path. ``solve_damped_cholesky_batched_plain`` applies it system by
  system.

The kernel is built on first use with every other source of ``csrc/``
(``ops/_nvcc.py``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import tracing
from ..precision import TINY
from . import _nvcc

# Launches of the kernel (one cooperative CUDA launch per solve), in all and
# by system dim, read by chip_smoke.py to show that the main path ran
# through the kernel.
LAUNCHES = 0
LAUNCHES_BY_DIM = collections.Counter()
# Launches of the batched entry (one cooperative launch per batch), in all
# and by (batch, dim).
LAUNCHES_BATCHED = 0
LAUNCHES_BATCHED_BY_SHAPE = collections.Counter()

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
        lib.tids_damped_solve_batched.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp, vp, vp]
        lib.tids_damped_solve_batched.restype = ctypes.c_int
        lib.tids_damped_solve_batched_grid.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tids_damped_solve_batched_grid.restype = ctypes.c_int
        lib.tids_damped_solve_timed.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.tids_damped_solve_timed.restype = ctypes.c_int
        _lib = lib
    return _lib


def damped_solve_cuda(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """x = -(H + lam I)^-1 g by the CUDA kernel; H [n, n] and g [n] f32 on
    the card, lam a float or a one-element tensor. Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
    n = g.shape[0] if g.ndim == 1 else -1
    if H.shape != (n, n):
        raise ValueError(f"shapes H {tuple(H.shape)} and g {tuple(g.shape)} do not form one system")
    x = _launch("damped_solve_cuda", H[None], g[None], _nvcc.lam_tensor(lam, H))[0]
    LAUNCHES += 1
    LAUNCHES_BY_DIM[n] += 1
    return x


def damped_solve_batched_cuda(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """x[k] = -(H[k] + lam[k] I)^-1 g[k] for the whole batch in one launch of
    the CUDA kernel; H [B, n, n], g [B, n] f32 on the card, lam [B] (or
    anything of B values). Launches on the current stream and does not
    synchronise."""
    global LAUNCHES_BATCHED
    if H.ndim != 3 or H.shape[2] != H.shape[1] or g.shape != H.shape[:2] or H.shape[0] == 0:
        raise ValueError(f"shapes H {tuple(H.shape)} and g {tuple(g.shape)} do not form a batch of systems")
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=H.device).reshape(-1)
    x = _launch("damped_solve_batched_cuda", H, g, lam_t)
    LAUNCHES_BATCHED += 1
    LAUNCHES_BATCHED_BY_SHAPE[tuple(g.shape)] += 1
    return x


def _launch(name: str, H: torch.Tensor, g: torch.Tensor, lam_t: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel's batched entry (the single solve is B = 1):
    H [B, n, n], g [B, n], lam_t [B]; raises on anything but f32 tensors on
    one CUDA device, and when the card refuses the launch."""
    if H.device.type != "cuda" or g.device != H.device:
        raise ValueError(f"{name} takes H and g on one CUDA device")
    if H.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 H and g")
    B, n = g.shape
    if lam_t.numel() != B:
        raise ValueError(f"{lam_t.numel()} damping values for {B} systems")
    lib = _load()
    H = H.contiguous()
    g = g.contiguous()
    lam_t = lam_t.contiguous()
    npad = lib.tids_damped_solve_pad(n)
    opts = dict(dtype=torch.float32, device=H.device)
    x = torch.empty(B, n, **opts)
    L = torch.empty(B, npad * npad, **opts)
    Linv = torch.empty(B, npad * 32, **opts)
    vecs = torch.empty(B, 4, npad, **opts)  # s, b, y, x0 of each system
    with tracing.kernel("kernel1", H.device):
        err = lib.tids_damped_solve_batched(
            H.data_ptr(), g.data_ptr(), lam_t.data_ptr(), x.data_ptr(), B, n,
            L.data_ptr(), Linv.data_ptr(), vecs.data_ptr(), _nvcc.stream_ptr(H.device),
        )
    if err != 0:
        raise RuntimeError(f"damped-Cholesky kernel launch failed ({name}, {B} x {n}): cudaError_t {err}")
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


def solve_damped_cholesky_batched_plain(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """The plain version system by system: H [B, n, n], g [B, n], lam [B]."""
    lam_t = torch.as_tensor(lam, dtype=H.dtype, device=H.device).reshape(-1)
    return torch.stack([solve_damped_cholesky_plain(H[k], g[k], lam_t[k]) for k in range(H.shape[0])])
