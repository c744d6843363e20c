"""Plain PyTorch/NumPy reference of the two-view deformable refinement.

The benchmark's output check holds the program under test against it. It
imports nothing of the program and takes nothing the program made: it works
out the observations, the triangulation, the mesh, the frozen rotations and
every solve again from the raw inputs (ground-truth points, noise seed,
configuration).
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products in full float32 (the configuration's
    precision) or, for the output check's control, in TF32; the previous
    setting is restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
