"""Block-Jacobi PCG over the ELLPACK Gauss-Newton operator: the
hand-written CUDA kernel, its wrapper, its plain PyTorch version and the
device dispatch of the large-N LM step.

One call solves one damped trial, (H + lam I) x = b from x0 = 0, with the
early exit ||r|| <= rtol ||b|| and the cap ``iters``, as the JAX package's
large-N path does (``models/block_system.py:464-473``: ``pcg_flex`` over
``block_matvec`` and ``block_jacobi_apply``). The kernel
(``csrc/block_pcg.cu``) replaces the TPU kernel
``ops/pallas_pcg.py:221 pcg_block_system``; its source states its bound and
design. The TPU-only parts of that module (the lane "planes" transposes and
``fits_vmem``) have no counterpart here.

- ``pcg_block_system_cuda`` launches the kernel on CUDA tensors and raises
  on anything else. ``LAUNCHES``/``LAUNCHES_BY_DIM`` count its calls (one
  cooperative CUDA launch each); the kernel adds the iterations it took to
  a running total on the device (``iterations_total``), which nothing in
  the LM loop reads.
- ``pcg_block_system_plain`` is ``pcg_flex(block_matvec,
  block_jacobi_apply)`` with the same arguments: the CPU path and the
  oracle the kernel is held against.
- ``pcg_block_system`` is what ``make_block_step`` calls: a CUDA tensor
  goes to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _nvcc

# Calls of the kernel wrapper (one cooperative launch each), in all and by
# tangent dim, read by chip_smoke.py to show that the large-N path ran
# through the kernel.
LAUNCHES = 0
LAUNCHES_BY_DIM = collections.Counter()

_lib = None
_totals = {}


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load()
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tids_pcg_solve.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
                                       vp, vp, vp, vp]
        lib.tids_pcg_solve.restype = ci
        lib.tids_pcg_workspace_floats.argtypes = [ci]
        lib.tids_pcg_workspace_floats.restype = ctypes.c_longlong
        lib.tids_pcg_grid.argtypes = [ci]
        lib.tids_pcg_grid.restype = ci
        _lib = lib
    return _lib


def iterations_total(device) -> torch.Tensor:
    """The device's running total of kernel PCG iterations (int64 [1])."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _totals:
        _totals[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _totals[dev]


def pcg_block_system_cuda(sys, nbr: torch.Tensor, b: torch.Tensor, lam, iters: int, rtol: float):
    """(x, iterations) of the PCG solve by the CUDA kernel. ``sys`` is a
    ``BlockSystem`` of f32 CUDA tensors, ``nbr`` [N, K] int64 (-1 padded),
    ``b`` [6N + 8], ``lam`` a float or a one-element tensor. ``iterations``
    is a one-element int32 tensor on the card. Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
    n, K = nbr.shape
    dev = b.device
    tensors = (sys.D, sys.Bt, sys.C, sys.Hg, b)
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, nbr)):
        raise ValueError("pcg_block_system_cuda takes the system, nbr and b on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors) or nbr.dtype != torch.int64:
        raise TypeError("pcg_block_system_cuda takes float32 blocks and b, and int64 nbr")
    shapes = {"D": (n, 6, 6), "Bt": (n, K, 6, 6), "C": (n, 6, 8), "Hg": (8, 8)}
    for name, want in shapes.items():
        if tuple(getattr(sys, name).shape) != want:
            raise ValueError(f"{name} has shape {tuple(getattr(sys, name).shape)}, expected {want}")
    if tuple(b.shape) != (6 * n + 8,):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({6 * n + 8},)")
    lib = _load()
    D, Bt, C, Hg, b = (t.contiguous() for t in tensors)
    if Bt.data_ptr() % 16:
        raise ValueError("Bt must be 16-byte aligned")
    nbr = nbr.contiguous()
    lam_t = _nvcc.lam_tensor(lam, b)
    x = torch.empty_like(b)
    ws = torch.empty(int(lib.tids_pcg_workspace_floats(n)), dtype=torch.float32, device=dev)
    k = torch.empty(1, dtype=torch.int32, device=dev)
    total = iterations_total(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tids_pcg_solve(
        D.data_ptr(), Bt.data_ptr(), C.data_ptr(), Hg.data_ptr(), nbr.data_ptr(), b.data_ptr(),
        lam_t.data_ptr(), x.data_ptr(), n, K, int(iters), float(rtol) * float(rtol),
        ws.data_ptr(), k.data_ptr(), total.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"block-PCG kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DIM[6 * n + 8] += 1
    return x, k


def pcg_block_system_plain(sys, nbr: torch.Tensor, b: torch.Tensor, lam, iters: int, rtol: float):
    """(x, iterations) of ``pcg_flex`` over ``block_matvec`` and
    ``block_jacobi_apply``; plain PyTorch on any device."""
    from ..models import block_system as bs

    mv = lambda v: bs.block_matvec(sys, nbr, v, lam)
    return bs.pcg_flex(mv, b, bs.block_jacobi_apply(sys, lam), iters, rtol)


def pcg_block_system(sys, nbr: torch.Tensor, b: torch.Tensor, lam, iters: int, rtol: float) -> torch.Tensor:
    """x of the PCG solve: the CUDA kernel for a CUDA tensor (it raises if it
    cannot launch), the plain version for a CPU tensor."""
    if b.device.type == "cuda":
        return pcg_block_system_cuda(sys, nbr, b, lam, iters, rtol)[0]
    if b.device.type != "cpu":
        raise ValueError(f"no block PCG for device {b.device}")
    return pcg_block_system_plain(sys, nbr, b, lam, iters, rtol)[0]
