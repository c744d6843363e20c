"""PyTorch/CUDA port of ``triangulation_in_deformable_scenes_tpu``.

The JAX package beside this one is the reference; each module here mirrors
its counterpart under the same name and cites it by file and line. This
package imports ``torch`` and never ``jax`` or the JAX package: the numpy-only
modules it needs (``config``, ``utils/csvio``, ``utils/journal``,
``ops/delaunay``, ``ops/mesh``, ``harness/create_data``,
``harness/real_sweep``, ``harness/prep``, ``datasets/loaders``,
``ops/orb_pattern.npy``) are its own copies.

Device compute is f32 (``precision.py``); host preparation and metrics stay
numpy f64. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``device.py``). The hand-written kernels, one for each TPU
kernel of the JAX package: the damped-Cholesky solve
(``ops/damped_cholesky.py``, ``csrc/damped_cholesky.cu``; one launch for a
single system or for the serving path's batch), the block PCG
(``ops/block_pcg.py``, ``csrc/block_pcg.cu``) and the matcher's windowed
Hamming top-2 scan (``ops/match_scan.py``, ``csrc/match_scan.cu``).
"""

__version__ = "0.1.0"
