"""Locality-aware landmark sharding with explicit halo exchange.

Counterpart of ``triangulation_in_deformable_scenes_tpu/parallel/halo.py``
(see its docstring for the design). The baseline
(``dist.solve_pair_distributed``) exchanges the whole packed tangent [N, 6]
at every PCG matvec; here:

1. **Spatial reorder** (host, once per solve): the landmarks are permuted
   into Morton order of the xy of p1, the plane the Delaunay mesh was built
   over, and contiguous blocks of that order become the ranks' rows.
2. **Halo plan** (host, once per solve): the boundary set B, every landmark
   a neighbour slot of another rank reads. ``morton_perm``, ``plan_halo``,
   ``pad_pair`` and ``permute_data`` are the JAX package's numpy, so every
   array equals JAX's exactly.
3. **Halo PCG** (``pcg_halo_local``): each matvec's ONE all-reduce carries
   the [B, 6] boundary rows (each owner writes its rows into a zero buffer)
   fused with the 8-dim C^T v sum, 6 |B| + 8 floats; the interior
   contraction reads local values only, and the off-shard tail is the
   [E]-edge gather and sum after the exchange. With p.Ap and (r.z, r.r)
   that is three all-reduces a CG iteration (``dist.pcg_sharded``).

Assembly and cost still exchange the whole p1/p2 (``dist.ShardedPair``),
once per linearization and trial, as JAX's partitioner all-gathers there.
On a points axis of one rank the step is ``make_block_step`` on the
permuted pair: kernel 2 on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import block_system as bs_
from ..models import deformable as D_
from ..ops import lm as lm_ops
from . import dist


def morton_perm(xy: np.ndarray) -> np.ndarray:
    """Permutation sorting 2-D points along a Z-order (Morton) curve."""
    xy = np.asarray(xy, np.float64)
    mn = xy.min(axis=0)
    span = np.maximum(xy.max(axis=0) - mn, 1e-12)
    g = ((xy - mn) / span * 65535.0).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0xFFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
        return v

    code = spread(g[:, 0]) | (spread(g[:, 1]) << np.uint64(1))
    return np.argsort(code, kind="stable")


class HaloPlan(NamedTuple):
    """Host-computed shard layout (all arrays in the PERMUTED index space)."""

    perm: np.ndarray        # [N] new -> old landmark index
    inv_perm: np.ndarray    # [N] old -> new
    n_shards: int
    n_boundary: int         # true boundary count (arrays padded to >= 1)
    nbr_is_local: np.ndarray  # [N, K] neighbor lives on the same shard
    nbr_loc: np.ndarray       # [N, K] index into the owning shard's block
    nbr_halo: np.ndarray      # [N, K] index into the halo buffer (off-shard)
    halo_owner: np.ndarray    # [B] shard id owning each boundary row
    halo_local: np.ndarray    # [B] index within the owner's block
    # Off-shard edge lists, padded to a common per-shard length E.
    off_rows: np.ndarray    # [S, E] local row within the shard
    off_slots: np.ndarray   # [S, E] neighbor slot k of that row
    off_halo: np.ndarray    # [S, E] index into the halo buffer
    off_w: np.ndarray       # [S, E] 1.0 real / 0.0 padding


def plan_halo(xy, nbr, nbr_mask, n_shards: int) -> HaloPlan:
    """Build the Morton partition + halo exchange plan on the host
    (``halo.py:106-174``). ``xy`` is the 2-D layout the mesh was built over,
    the (x, y) of the KF1 points."""
    xy = np.asarray(xy)[:, :2]
    nbr = np.asarray(nbr)
    mask = np.asarray(nbr_mask, bool) & (nbr >= 0)
    n, _ = nbr.shape
    if n % n_shards != 0:
        raise ValueError(
            f"landmark count {n} not divisible by {n_shards} shards; use "
            f"pad_pair (solve_pair_halo does so automatically)"
        )
    perm = morton_perm(xy)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    nbr_new = np.where(mask, inv[np.maximum(nbr, 0)], -1)[perm]
    mask = mask[perm]

    n_loc = n // n_shards
    owner_row = np.arange(n) // n_loc
    nbr_owner = np.where(mask, nbr_new // n_loc, owner_row[:, None])
    off = mask & (nbr_owner != owner_row[:, None])

    boundary = np.unique(nbr_new[off]) if off.any() else np.zeros(0, np.int64)
    n_boundary = int(boundary.size)
    b_pad = max(n_boundary, 1)
    halo_owner = np.full(b_pad, -1, np.int32)
    halo_local = np.zeros(b_pad, np.int32)
    halo_owner[:n_boundary] = (boundary // n_loc).astype(np.int32)
    halo_local[:n_boundary] = (boundary % n_loc).astype(np.int32)
    halo_of = np.zeros(n, np.int64)
    halo_of[boundary] = np.arange(n_boundary)

    nbr_is_local = ~off
    nbr_loc = np.where(mask & nbr_is_local, nbr_new % n_loc, 0).astype(np.int32)
    nbr_halo = np.where(off, halo_of[np.maximum(nbr_new, 0)], 0).astype(np.int32)

    rows_g, ks_g = np.nonzero(off)
    shard_of = rows_g // n_loc
    counts = np.bincount(shard_of, minlength=n_shards)
    E = max(int(counts.max()) if counts.size else 0, 1)
    off_rows = np.zeros((n_shards, E), np.int32)
    off_slots = np.zeros((n_shards, E), np.int32)
    off_halo = np.zeros((n_shards, E), np.int32)
    off_w = np.zeros((n_shards, E), np.float32)
    for s in range(n_shards):
        sel = shard_of == s
        m = int(sel.sum())
        off_rows[s, :m] = (rows_g[sel] % n_loc).astype(np.int32)
        off_slots[s, :m] = ks_g[sel].astype(np.int32)
        off_halo[s, :m] = halo_of[nbr_new[rows_g[sel], ks_g[sel]]].astype(np.int32)
        off_w[s, :m] = 1.0
    return HaloPlan(
        perm=perm, inv_perm=inv, n_shards=n_shards, n_boundary=n_boundary,
        nbr_is_local=nbr_is_local, nbr_loc=nbr_loc, nbr_halo=nbr_halo,
        halo_owner=halo_owner, halo_local=halo_local,
        off_rows=off_rows, off_slots=off_slots, off_halo=off_halo, off_w=off_w,
    )


def pad_pair(data: D_.PairData, state: D_.PairState, multiple: int):
    """Pad the landmark axis of (data, state) to the next multiple
    (``halo.py:177-216``). Pad rows are invalid with no mesh edges, and sit
    at the valid centroid of p1 (a finite point in front of both cameras),
    so no masked product meets a NaN (0 * NaN). Returns (data, state,
    n_original)."""
    n = int(data.kp1.shape[0])
    pad = (-n) % multiple
    if pad == 0:
        return data, state, n
    vm = data.valid.cpu().numpy().astype(bool)
    # numpy's mean of the f32 rows, as JAX's pad_pair takes it.
    centroid = state.p1.cpu().numpy()[vm].mean(axis=0) if vm.any() else np.array([0.0, 0.0, 1.0])

    def rows(x, fill):
        if x.ndim == 0 or x.shape[0] != n:
            return x
        block = torch.as_tensor(np.asarray(fill), device=x.device).to(x.dtype)
        return torch.cat([x, block.expand((pad,) + tuple(x.shape[1:]))], dim=0)

    data = data._replace(
        kp1=rows(data.kp1, [0.0, 0.0]),
        kp2=rows(data.kp2, [0.0, 0.0]),
        inv_sigma2_1=rows(data.inv_sigma2_1, 1.0),
        inv_sigma2_2=rows(data.inv_sigma2_2, 1.0),
        depth1=rows(data.depth1, 1.0),
        depth2=rows(data.depth2, 1.0),
        valid=rows(data.valid, False),
        nbr=rows(data.nbr, -1),
        nbr_mask=rows(data.nbr_mask, False),
        wcot=rows(data.wcot, 0.0),
        Ri=rows(data.Ri, np.eye(3)),
    )
    state = state._replace(p1=rows(state.p1, centroid), p2=rows(state.p2, centroid))
    return data, state, n


def unpad_state(state: D_.PairState, n: int) -> D_.PairState:
    return state._replace(p1=state.p1[:n], p2=state.p2[:n])


def permute_data(data: D_.PairData, plan: HaloPlan) -> D_.PairData:
    """Reorder every per-point tensor into the plan's Morton layout and remap
    the adjacency values into the new index space."""
    n = plan.perm.shape[0]
    dev = data.kp1.device
    perm = torch.as_tensor(plan.perm, device=dev)
    fields = {name: (x[perm] if (x.ndim >= 1 and x.shape[0] == n) else x) for name, x in data._asdict().items()}
    nbr = data.nbr.cpu().numpy()
    mask = data.nbr_mask.cpu().numpy().astype(bool) & (nbr >= 0)
    nbr_new = np.where(mask, plan.inv_perm[np.maximum(nbr, 0)], -1)[plan.perm]
    fields["nbr"] = torch.as_tensor(nbr_new, dtype=torch.int64, device=dev)
    return D_.PairData(**fields)


def permute_state(state: D_.PairState, plan: HaloPlan) -> D_.PairState:
    perm = torch.as_tensor(plan.perm, device=state.p1.device)
    return state._replace(p1=state.p1[perm], p2=state.p2[perm])


def unpermute_state(state: D_.PairState, plan: HaloPlan) -> D_.PairState:
    inv = torch.as_tensor(plan.inv_perm, device=state.p1.device)
    return state._replace(p1=state.p1[inv], p2=state.p2[inv])


def pcg_halo_local(sp: dist.ShardedPair, sys: bs_.BlockSystem, lam, plan_arrays, cg_iters: int, rtol: float):
    """This rank's part of the halo PCG (``halo.py:251-347``): solves
    (H + lam I) x = -g with block-Jacobi preconditioning and three
    all-reduces a CG iteration (``dist.pcg_sharded``), the matvec's being
    the fused [6 |B| + 8] buffer of the boundary rows and C^T v. Returns
    (x_p, x_g)."""
    (nbr_is_local, nbr_loc, off_rows, off_slots, off_halo, off_w, halo_owner, halo_local) = plan_arrays
    my = sp.mesh.axis_index(dist.POINTS_AXIS)
    own = (halo_owner == my)[:, None]
    nb = halo_local.shape[0]
    vj_mask = nbr_is_local[..., None]
    Bt_off = sys.Bt[off_rows, off_slots] * off_w[:, None, None]  # [E, 6, 6]
    n_loc, K = nbr_loc.shape

    def matvec(v_p, v_g):
        # Fused exchange: boundary rows + the C^T v_p sum in ONE all-reduce.
        halo_in = torch.where(own, v_p[halo_local], torch.zeros((), dtype=v_p.dtype, device=v_p.device))
        cg_part = torch.einsum("nag,na->g", sys.C, v_p)
        buf = sp.reduce(torch.cat([halo_in.reshape(-1), cg_part]), "pcg_matvec")
        halo = buf[: nb * 6].reshape(nb, 6)
        # Interior stream: off-shard slots read zero.
        vj = torch.where(vj_mask, v_p[nbr_loc], torch.zeros((), dtype=v_p.dtype, device=v_p.device))
        y_p = (
            torch.einsum("nab,nb->na", sys.D, v_p)
            + torch.einsum("nkab,nkb->na", sys.Bt, vj)
            + torch.einsum("nag,g->na", sys.C, v_g)
            + lam * v_p
        )
        # Off-shard tail: each (row, slot) edge written once into a dense
        # [n_loc, K, 6] buffer and summed over the slots, so a row's edges
        # add in one fixed order on either device.
        tail = torch.zeros((n_loc, K, 6), dtype=v_p.dtype, device=v_p.device)
        tail[off_rows, off_slots] = torch.einsum("eab,eb->ea", Bt_off, halo[off_halo])
        y_p = y_p + tail.sum(dim=1)
        y_g = buf[nb * 6:] + sys.Hg @ v_g + lam * v_g
        return y_p, y_g

    return dist.pcg_sharded(sp, sys, lam, matvec, cg_iters, rtol)


def make_halo_step(mesh: dist.Mesh, cam_kind, data, hyper, spec, plan_arrays, cg_iters: int, cg_rtol: float,
                   pair: dist.ShardedPair | None = None):
    """LM step factory (``ops.lm.lm_optimize_general`` contract) whose damped
    solves run the halo PCG over this rank's rows (``halo.py:350-389``); on
    a points axis of one rank, ``make_block_step`` (kernel 2 on the card).
    ``pair`` is this rank's ``dist.sharded_pair``, made here if not given."""
    if pair is None:
        pair = dist.sharded_pair(mesh, cam_kind, data, hyper, spec)
    if pair is None:
        return bs_.make_block_step(cam_kind, data, hyper, spec, cg_iters, cg_rtol)
    return pair.step(lambda sys, lam: pcg_halo_local(pair, sys, lam, plan_arrays, cg_iters, cg_rtol))


def build_halo_solver(mesh: dist.Mesh, cam_kind: str, n_iterations: int, cg_iters: int = 50, max_trials: int = 6,
                      spec: D_.ModelSpec = D_.ModelSpec()):
    """Solver factory (``halo.py:392-415``): the returned callable takes
    (data, hyper, state0, plan_arrays), this rank's rows in the PERMUTED
    layout, and runs the shared LM damping loop with ``make_halo_step``."""

    def run(data, hyper, state0, plan_arrays):
        pair = dist.sharded_pair(mesh, cam_kind, data, hyper, spec)
        make_step = make_halo_step(mesh, cam_kind, data, hyper, spec, plan_arrays, cg_iters, D_.CG_RTOL, pair)
        return dist.optimize_rows(pair, cam_kind, data, hyper, spec, make_step, state0, n_iterations, max_trials)

    return run


def place_plan(mesh: dist.Mesh, plan: HaloPlan):
    """This rank's plan tensors on its device: its rows of the [N, K]
    arrays, its own off-shard edges (the real ones of its [E] list), and
    the boundary's owner/local index replicated."""
    dev = mesh.device
    s = mesh.axis_index(dist.POINTS_AXIS)
    m = int(plan.off_w[s].sum())

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return (
        dist.rows_of(mesh, dist.POINTS_AXIS, t(plan.nbr_is_local, torch.bool)),
        dist.rows_of(mesh, dist.POINTS_AXIS, t(plan.nbr_loc)),
        t(plan.off_rows[s, :m]),
        t(plan.off_slots[s, :m]),
        t(plan.off_halo[s, :m]),
        t(plan.off_w[s, :m], torch.float32),
        t(plan.halo_owner),
        t(plan.halo_local),
    )


# One process per rank holds only its own rows either way: the multi-process
# placement is the same function.
place_plan_global = place_plan


def _plan_and_shard(mesh, data, state0):
    S = mesh.axis_size(dist.POINTS_AXIS)
    data, state0, n_orig = pad_pair(data, state0, S)
    plan = plan_halo(state0.p1.cpu().numpy(), data.nbr.cpu().numpy(), data.nbr_mask.cpu().numpy(), S)
    data_p, state_p = dist.shard_pair(mesh, permute_data(data, plan), permute_state(state0, plan))
    return data_p, state_p, plan, n_orig


def solve_pair_halo(
    mesh: dist.Mesh,
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state0: D_.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    spec: D_.ModelSpec = D_.ModelSpec(),
) -> lm_ops.LMResult:
    """One-call wrapper (``halo.py:441-475``): pad, plan, permute, take this
    rank's rows, solve, then gather, unpermute and unpad, so that every rank
    returns the whole pair's state. Every rank passes the same whole
    (data, state0); the plan is deterministic, so all compute one layout."""
    data_p, state_p, plan, n_orig = _plan_and_shard(mesh, data, state0)
    run = build_halo_solver(mesh, cam_kind, n_iterations, cg_iters=cg_iters, max_trials=max_trials, spec=spec)
    result = run(data_p, hyper, state_p, place_plan(mesh, plan))
    state = dist.gather_state(mesh, result.state)
    return result._replace(state=unpad_state(unpermute_state(state, plan), n_orig))


def solve_pair_halo_global(
    mesh: dist.Mesh,
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state0: D_.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    spec: D_.ModelSpec = D_.ModelSpec(),
):
    """Cross-process ``solve_pair_halo`` (``halo.py:499-539``): returns
    (LMResult with this rank's rows of the state in the PERMUTED+PADDED
    layout, plan, n_original); costs are the whole pair's on every rank."""
    data_p, state_p, plan, n_orig = _plan_and_shard(mesh, data, state0)
    run = build_halo_solver(mesh, cam_kind, n_iterations, cg_iters=cg_iters, max_trials=max_trials, spec=spec)
    return run(data_p, hyper, state_p, place_plan_global(mesh, plan)), plan, n_orig
