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
  the LM loop reads. While tracing is on, each launch is timed by CUDA
  events (``tracing.kernel``, family ``kernel2``). A call allocates one
  tensor, its result (x and the iteration count); the kernel's workspace is
  kept per device and point count (``_workspace``).
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

from .. import tracing
from . import _nvcc

# Calls of the kernel wrapper (one cooperative launch each), in all and by
# tangent dim, read by chip_smoke.py to show that the large-N path ran
# through the kernel.
LAUNCHES = 0
LAUNCHES_BY_DIM = collections.Counter()

_lib = None
_totals = {}
_workspaces = {}


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load()
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tids_pcg_solve.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
                                       vp, vp, vp, vp]
        lib.tids_pcg_solve.restype = ci
        lib.tids_pcg_solve_timed.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
                                             vp, vp, vp, vp, vp]
        lib.tids_pcg_solve_timed.restype = ci
        lib.tids_pcg_workspace_floats.argtypes = [ci, ci]
        lib.tids_pcg_workspace_floats.restype = ctypes.c_longlong
        lib.tids_pcg_grid.argtypes = [ci, ci]
        lib.tids_pcg_grid.restype = ci
        lib.tids_pcg_resident.argtypes = [ci, ci]
        lib.tids_pcg_resident.restype = ci
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


def _workspace(lib, dev, n: int, K: int) -> torch.Tensor:
    """The kernel's workspace for ``n`` points with ``K`` neighbour slots on
    ``dev``, made once and then reused by every solve of that size. Sharing
    it is safe because the wrapper launches on PyTorch's current stream,
    which orders the solves; two solves of one size on two streams at once
    would race."""
    key = (dev, n, K)
    ws = _workspaces.get(key)
    if ws is None:
        floats = int(lib.tids_pcg_workspace_floats(n, K))
        if floats < 0:
            raise RuntimeError(f"block-PCG workspace query failed: cudaError_t {-floats}")
        ws = _workspaces[key] = torch.zeros(floats, dtype=torch.float32, device=dev)
    return ws


def pcg_block_system_cuda(sys, nbr: torch.Tensor, b: torch.Tensor, lam, iters: int, rtol: float):
    """(x, iterations) of the PCG solve by the CUDA kernel. ``sys`` is a
    ``BlockSystem`` of f32 CUDA tensors, ``nbr`` [N, K] int64 (-1 padded),
    ``b`` [6N + 8], ``lam`` a float or a one-element tensor. ``iterations``
    is a one-element int32 tensor on the card, a view of the same result
    tensor as x, so later calls leave it as it is. Launches on the current
    stream and does not synchronise."""
    out = _solve(sys, nbr, b, lam, iters, rtol)
    m = out.shape[0] - 1
    return out[:m], out[m:].view(torch.int32)


def _solve(sys, nbr: torch.Tensor, b: torch.Tensor, lam, iters: int, rtol: float) -> torch.Tensor:
    """One kernel launch; returns its result, [6N + 9] f32: x, then the
    iteration count's int32 bits."""
    global LAUNCHES
    n, K = nbr.shape
    dev = b.device
    tensors = (sys.D, sys.Bt, sys.C, sys.Hg, b)
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors, nbr)):
        raise ValueError("pcg_block_system_cuda takes the system, nbr and b on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors) or nbr.dtype != torch.int64:
        raise TypeError("pcg_block_system_cuda takes float32 blocks and b, and int64 nbr")
    D, Bt, C, Hg = sys.D, sys.Bt, sys.C, sys.Hg
    if (D.shape != (n, 6, 6) or Bt.shape != (n, K, 6, 6) or C.shape != (n, 6, 8) or Hg.shape != (8, 8)
            or b.shape != (6 * n + 8,)):
        raise ValueError(f"block shapes D {tuple(D.shape)}, Bt {tuple(Bt.shape)}, C {tuple(C.shape)}, "
                         f"Hg {tuple(Hg.shape)}, b {tuple(b.shape)} do not fit nbr {(n, K)}")
    if not all(t.is_contiguous() for t in (*tensors, nbr)):
        D, Bt, C, Hg, b, nbr = (t.contiguous() for t in (*tensors, nbr))
    if Bt.data_ptr() % 16:
        raise ValueError("Bt must be 16-byte aligned")
    lib = _load()
    if isinstance(lam, torch.Tensor) and lam.numel() == 1 and lam.dtype == torch.float32 and lam.device == dev:
        lam_t = lam
    else:
        lam_t = _nvcc.lam_tensor(lam, b)
    out = torch.empty(6 * n + 9, dtype=torch.float32, device=dev)
    x = out.data_ptr()
    ws = _workspace(lib, dev, n, K).data_ptr()
    with tracing.kernel("kernel2", dev):
        err = lib.tids_pcg_solve(
            D.data_ptr(), Bt.data_ptr(), C.data_ptr(), Hg.data_ptr(), nbr.data_ptr(), b.data_ptr(),
            lam_t.data_ptr(), x, n, K, int(iters), float(rtol) * float(rtol),
            ws, x + 4 * (6 * n + 8), iterations_total(dev).data_ptr(), _nvcc.stream_ptr(dev),
        )
    if err != 0:
        raise RuntimeError(f"block-PCG kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DIM[6 * n + 8] += 1
    return out


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
        return _solve(sys, nbr, b, lam, iters, rtol)[:-1]
    if b.device.type != "cpu":
        raise ValueError(f"no block PCG for device {b.device}")
    return pcg_block_system_plain(sys, nbr, b, lam, iters, rtol)[0]
