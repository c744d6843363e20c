"""Peaks of the card and the least time of each kernel's work, from shapes.

Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its full 700 W
power limit: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM bandwidth. A card set below 700 W runs slower under load; the run
records the card's name and power limit beside every share.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def damped_solve_s(dim: int) -> float:
    """Kernel 1 (the damped Cholesky), one system: the larger of its
    operations (dim^3 / 3 for the factorization, ~10 dim^2 for the four
    triangular solves and the refinement's matvec) at the float32 peak and
    of H, g and x moved once at the HBM peak."""
    ops = dim**3 / 3.0 + 10.0 * dim**2
    nbytes = 4.0 * (dim * dim + 2 * dim + 1)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def damped_solve_batched_s(batch: int, dim: int) -> float:
    """Kernel 1's batched entry: ``batch`` systems of one dim."""
    return batch * damped_solve_s(dim)


def block_pcg_s(n: int, K: int) -> float:
    """Kernel 2 (block-Jacobi PCG), one solve of n points with K neighbour
    slots: its inputs read once (D [n,6,6], Bt [n,K,6,6], C [n,6,8], Hg [8,8]
    and b [6n+8] in float32, nbr [n,K] in int64, the damping) and x written
    once, at the HBM peak. The iterations it takes depend on the data and are
    not counted."""
    dim = 6 * n + 8
    nbytes = 4.0 * (n * 36 + n * K * 36 + n * 48 + 64 + 2 * dim + 1) + 8.0 * n * K
    return nbytes / PEAK_BYTES_PER_S
