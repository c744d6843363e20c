"""Windowed Hamming top-2 scan of the initial matcher: the hand-written CUDA
kernel, its wrapper, its plain PyTorch version and the device dispatch.

For each reference row i, over every current column j: D = Hamming(desc_i,
desc_j); column j is allowed iff dx^2 + dy^2 <= r_i^2, oct_i - 1 <= oct_j <=
oct_i + 1, row_ok_i and valid_j; Dm = D where allowed, else BIG. Outputs per
row: best_d = min Dm, best = the first column that attains it, second_d =
min of Dm over every column other than best (two columns tied at the best
give second_d == best_d; a row with no allowed column gives BIG, 0, BIG).

The kernel (``csrc/match_scan.cu``) replaces the TPU kernel
``triangulation_in_deformable_scenes_tpu/ops/pallas_kernels.py:156
fused_search_for_initialization`` (its scan ``_match_scan`` :105, body
``_match_kernel`` :45). Bound: per pair a window test (8 operations) and,
where allowed, 8 XOR + 8 popc + adds over 32 bytes of packed bits; the
inputs are ~48 bytes a key, so at the path's sizes (1000 x 1000) the bound
is well under a microsecond and the kernel is latency-bound. Design: two
CUDA launches per scan. The first packs both sides' [N, 256] uint8 bits
into [N, 8] uint32 words with ``__ballot_sync`` (the layout of
``pack_bits``, which stays as its oracle); the second gives each reference
row a warp, whose lanes scan every 32nd column of shared-memory tiles in
ascending order and keep their own best, argmin and second, then merge
them by (distance, column), so the first occurrence wins as in the plain
version; no atomics, so results repeat to the bit. The window test rounds
each op (``__fmul_rn``/``__fadd_rn``, no FMA contraction) and takes r^2
from ``row_meta``, so keys on the circle fall as in the plain version.

- ``match_scan_cuda`` launches the kernels on CUDA tensors on one device
  and raises on anything else; it reads the octaves (int32), masks (bool)
  and bits (uint8) as ``matching.search_for_initialization`` hands them
  over, allocates its result and keeps the packed words in a workspace per
  device. ``LAUNCHES`` counts its calls (one scan, two CUDA launches,
  each).
- ``match_scan_plain`` is the dense formula of ``matching.py:91-113``: the
  CPU path and the oracle the kernel is held against.
- ``match_scan`` is what ``matching.search_for_initialization`` calls: a
  CUDA tensor goes to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

BIG = 1_000_000.0

# Calls of the kernel wrapper (one scan each), read by chip_smoke.py to show
# that the sequence path ran through the kernel.
LAUNCHES = 0

_lib = None
_packed = {}


def _load():
    global _lib
    if _lib is None:
        lib = _nvcc.load()
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.tids_match_scan.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp]
        lib.tids_match_scan.restype = ci
        _lib = lib
    return _lib


def row_meta(kp_ref, octave_ref, valid_ref, scale_factors, window_factor: float, max_octave: int):
    """(r^2 [N1] f32, row_ok [N1] bool) of the reference rows: radius =
    window_factor * scale_factors[clip(octave)], squared in f32; a row takes
    part iff octave <= max_octave and it is valid."""
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=kp_ref.device)
    radius = window_factor * sf[octave_ref.clamp(0, len(sf) - 1).long()]
    return radius**2, (octave_ref <= max_octave) & valid_ref


def pack_bits(desc) -> torch.Tensor:
    """[N, 256] 0/1 bits -> [N, 8] int32 words (bit b of word w is column
    32 w + b), the layout the kernel reads as uint32."""
    n = desc.shape[0]
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    words = (desc.reshape(n, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _aligned(t, nbytes):
    """``t`` contiguous with its data on an ``nbytes`` boundary (the kernel
    reads float2 vectors): ``t`` itself where it already is."""
    if t.is_contiguous() and t.data_ptr() % nbytes == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _packed_words(dev, rows: int) -> torch.Tensor:
    """The device's workspace for ``rows`` packed descriptors ([rows, 8]
    int32 at least), grown when a scan needs more. Launches are ordered on
    PyTorch's current stream, so scans that share it do not race; scans on
    two streams at once would."""
    ws = _packed.get(dev)
    if ws is None or ws.shape[0] < rows:
        ws = _packed[dev] = torch.empty(max(rows, 2048), 8, dtype=torch.int32, device=dev)
    return ws


def match_scan_cuda(kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur):
    """(best_d [N1] f32, best [N1] int32, second_d [N1] f32) by the CUDA
    kernel, three views of one result tensor. Keypoints [N, 2] f32, r2 [N1]
    f32, octaves int32, masks bool, descriptors [N, 256] uint8 0/1, all on
    one CUDA device. Launches on the current stream and does not
    synchronise."""
    global LAUNCHES
    tensors = (kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur)
    dev = kp_ref.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("match_scan_cuda takes every input on one CUDA device")
    n1, n2 = kp_ref.shape[0], kp_cur.shape[0]
    if n1 == 0 or n2 == 0:
        raise ValueError("match_scan_cuda needs at least one row and one column")
    shapes = [(kp_ref, (n1, 2)), (r2, (n1,)), (octave_ref, (n1,)), (row_ok, (n1,)), (desc_ref, (n1, 256)),
              (kp_cur, (n2, 2)), (octave_cur, (n2,)), (valid_cur, (n2,)), (desc_cur, (n2, 256))]
    for t, want in shapes:
        if t.shape != want:
            raise ValueError(f"input of shape {tuple(t.shape)}, expected {want}")
    if kp_ref.dtype != torch.float32 or kp_cur.dtype != torch.float32 or r2.dtype != torch.float32:
        raise TypeError("match_scan_cuda takes float32 keypoints and r2")
    if octave_ref.dtype != torch.int32 or octave_cur.dtype != torch.int32:
        raise TypeError("match_scan_cuda takes int32 octaves")
    if row_ok.dtype != torch.bool or valid_cur.dtype != torch.bool:
        raise TypeError("match_scan_cuda takes bool masks")
    if desc_ref.dtype != torch.uint8 or desc_cur.dtype != torch.uint8:
        raise TypeError("match_scan_cuda takes uint8 descriptor bits")
    lib = _load()
    kp_ref, kp_cur = _aligned(kp_ref, 8), _aligned(kp_cur, 8)
    r2, octave_ref, row_ok, desc_ref, octave_cur, valid_cur, desc_cur = (
        t if t.is_contiguous() else t.contiguous()
        for t in (r2, octave_ref, row_ok, desc_ref, octave_cur, valid_cur, desc_cur))
    words = _packed_words(dev, n1 + n2)
    out = torch.empty(3, n1, dtype=torch.float32, device=dev)
    best_d, best, second_d = out[0], out[1].view(torch.int32), out[2]
    err = lib.tids_match_scan(
        kp_ref.data_ptr(), r2.data_ptr(), octave_ref.data_ptr(), row_ok.data_ptr(), desc_ref.data_ptr(),
        kp_cur.data_ptr(), octave_cur.data_ptr(), valid_cur.data_ptr(), desc_cur.data_ptr(), n1, n2,
        words.data_ptr(), words[n1].data_ptr(), best_d.data_ptr(), best.data_ptr(), second_d.data_ptr(),
        _nvcc.stream_ptr(dev),
    )
    if err != 0:
        raise RuntimeError(f"match-scan kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return best_d, best, second_d


def match_scan_plain(kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur):
    """The dense formula (``matching.py:91-113``) on any device: the [N1, N2]
    Hamming and window matrices, then ``_best_second_best``. Returns the
    kernel's outputs and types."""
    from . import matching

    D = matching.hamming_matrix(desc_ref, desc_cur)
    in_window = matching._window_d2(kp_ref, kp_cur) <= r2[:, None]
    allowed = in_window & matching._octave_ok(octave_ref, octave_cur) & row_ok[:, None] & valid_cur[None, :]
    Dm = torch.where(allowed, D, torch.full_like(D, BIG))
    best, best_d, second_d = matching._best_second_best(Dm)
    return best_d, best.to(torch.int32), second_d


def match_scan(kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur):
    """The scan: the CUDA kernel for a CUDA tensor (it raises if it cannot
    launch), the plain version for a CPU tensor."""
    args = (kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur)
    if kp_ref.device.type == "cuda":
        return match_scan_cuda(*args)
    if kp_ref.device.type != "cpu":
        raise ValueError(f"no match scan for device {kp_ref.device}")
    return match_scan_plain(*args)
