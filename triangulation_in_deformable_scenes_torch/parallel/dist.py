"""Landmark- and pair-sharded refinement over ``torch.distributed`` ranks.

Counterpart of ``triangulation_in_deformable_scenes_tpu/parallel/dist.py``.
There one controller places arrays on a ``jax.sharding.Mesh`` and XLA
partitions the program; here one process runs per rank on one device, holds
its own rows, and every exchange is an explicit all-reduce:

- ``Mesh`` names the ranks' axes (``POINTS_AXIS``, ``PAIRS_AXIS``) and holds
  the process group of each; an axis of one rank issues no collective, so a
  world of one process needs no process group at all.
- Pair sharding (``shard_pairs``, ``solve_pairs_sharded``): each rank refines
  its slice of the batch with ``deformable.solve_pairs`` (on the card, one
  launch of kernel 1's batched entry a global step), with no collective
  inside the solve; ``gather_pairs`` then gives every rank the whole
  batch's ``LMResult``, as JAX's global array reads.
- Landmark sharding, the baseline (``shard_pair``,
  ``solve_pair_distributed``): on one rank it is ``make_block_step``
  (kernel 2 on the card). On more, each rank assembles its rows of the
  block system after an exchange of the whole p1/p2 (what XLA's all-gather
  did), ``Hg``, ``g_g`` and diag max are all-reduced, and each PCG matvec
  exchanges the whole packed [N, 6] tangent with the C^T v sum.

Every gather is an all-reduce of a zero-filled buffer into which each owner
writes its rows: exact (x + 0 = x), and it runs on NCCL and on gloo with
CUDA tensors alike. Every branch the host takes (the LM accept, the PCG
stop test) reads an all-reduced value, so all ranks take it together, and
the shared 8x8 block is inverted only after its sum is reduced, so every
rank holds the same bits. ``COUNTS`` records the all-reduces by purpose.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as tdist

from ..device import resolve_device
from ..models import block_system as bs_
from ..models import deformable as D_
from ..ops import lm as lm_ops
from ..precision import TINY

POINTS_AXIS = "points"
PAIRS_AXIS = "pairs"

# All-reduces issued and floats reduced, by tag ("<tag>" and
# "<tag>_floats"), plus the sharded PCG's "cg_iterations" and
# "pcg_solves": per CG iteration the PCG issues one "pcg_matvec" (the fused
# exchange), one "pcg_dot" (p.Ap) and one "pcg_rz_rr"; one more "pcg_rz_rr"
# starts each solve.
COUNTS = collections.Counter()


def reset_counts():
    COUNTS.clear()


def world() -> tuple:
    """(world size, rank) of the process group; (1, 0) without one."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``device``, with a CUDA device's index the
    current one (``multihost.initialize`` sets it from the local rank)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Ranks laid out on named axes, the counterpart of ``jax.sharding.Mesh``.

    ``ranks`` holds the global ranks in the layout's shape (one dim per
    axis); ``groups`` the process group of this rank's line along each axis
    (None for the default group, or where the axis has one rank and no
    collective is issued)."""

    def __init__(self, axis_names, ranks, groups, device):
        self.axis_names = tuple(axis_names)
        self.ranks = np.asarray(ranks)
        self.groups = tuple(groups)
        self.device = device
        self.rank = world()[1]
        where = np.argwhere(self.ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not once in the mesh {self.ranks.tolist()}")
        self.coords = tuple(int(c) for c in where[0])

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis) -> int:
        return int(self.ranks.shape[self.axis_names.index(axis)])

    def axis_index(self, axis) -> int:
        return self.coords[self.axis_names.index(axis)]

    def all_reduce(self, t: torch.Tensor, axis, tag: str) -> torch.Tensor:
        """Sum ``t`` over ``axis`` in place and return it: one collective,
        counted under ``tag``; none on an axis of one rank."""
        if self.axis_size(axis) == 1:
            return t
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=self.groups[self.axis_names.index(axis)])
        COUNTS[tag] += 1
        COUNTS[tag + "_floats"] += t.numel()
        return t


def axis_groups(grid: np.ndarray) -> list:
    """Per axis of the rank grid, this rank's process group along it. Every
    rank makes every line's group, in one order, as ``new_group`` needs."""
    n_world, rank = world()
    groups = []
    for a in range(grid.ndim):
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        mine = None
        if grid.shape[a] > 1 and grid.shape[a] < n_world:
            for line in lines:
                g = tdist.new_group([int(r) for r in line])
                if rank in line:
                    mine = g
        groups.append(mine)
    return groups


def _line_mesh(axis, device) -> Mesh:
    n_world, _ = world()
    return Mesh((axis,), np.arange(n_world), [None], rank_device(device))


def make_mesh(device="cuda") -> Mesh:
    """1-D layout of every rank over the landmark axis."""
    return _line_mesh(POINTS_AXIS, device)


def make_serving_mesh(device="cuda") -> Mesh:
    """1-D layout of every rank over the keyframe-PAIR axis (data-parallel serving)."""
    return _line_mesh(PAIRS_AXIS, device)


def rows_of(mesh: Mesh, axis, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the leading dim of ``x`` along ``axis``."""
    S, i = mesh.axis_size(axis), mesh.axis_index(axis)
    m = x.shape[0] // S
    return x[i * m:(i + 1) * m]


def gather_rows(mesh: Mesh, axis, x: torch.Tensor, tag: str) -> torch.Tensor:
    """The whole leading dim from each rank's block of it: the owners write
    into a zero buffer and one all-reduce sums it (exact)."""
    S = mesh.axis_size(axis)
    if S == 1:
        return x
    m = x.shape[0]
    i = mesh.axis_index(axis)
    buf = x.new_zeros((S * m,) + tuple(x.shape[1:]))
    buf[i * m:(i + 1) * m] = x
    return mesh.all_reduce(buf, axis, tag)


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)


def shard_pairs(mesh: Mesh, data: D_.PairData, state: D_.PairState, hyper: D_.Hyper | None = None):
    """This rank's slice of a BATCH of pairs (leading pair axis on every
    tensor) along the pairs axis (``dist.py:59-109``): each rank refines its
    own pairs independently.

    Contract (validated, with JAX's messages): every field of ``data`` and
    ``state`` carries the leading pair axis of size b, and b divides evenly
    over the pairs axis. ``hyper`` fields are per-pair iff 1-D of length b
    (sliced); others are replicated.
    """
    b = data.kp1.shape[0]
    n_dev = mesh.axis_size(PAIRS_AXIS)
    if b % n_dev != 0:
        raise ValueError(
            f"pair batch size {b} is not divisible by the {n_dev}-device "
            f"'{PAIRS_AXIS}' mesh axis; pad the pair batch to a multiple"
        )

    def place(tup):
        out = {}
        for name, x in tup._asdict().items():
            x = _to(x, mesh.device)
            if x.ndim < 1 or x.shape[0] != b:
                raise ValueError(
                    f"shard_pairs: leaf .{name} has shape {tuple(x.shape)}; every data/state leaf must carry "
                    f"the leading pair axis of size {b} (stack the per-pair values)"
                )
            out[name] = rows_of(mesh, PAIRS_AXIS, x)
        return type(tup)(**out)

    out = (place(data), place(state))
    if hyper is not None:
        def place_hyper(x):
            x = _to(x, mesh.device)
            return rows_of(mesh, PAIRS_AXIS, x) if (x.ndim == 1 and x.shape[0] == b) else x

        out = out + (D_.Hyper(*(place_hyper(x) for x in hyper)),)
    return out


def gather_pairs(mesh: Mesh, result: lm_ops.LMResult) -> lm_ops.LMResult:
    """The whole batch's ``LMResult`` on every rank from each rank's slice
    (one all-reduce: every per-pair value packed into one f32 row a pair).
    ``n_solves`` stays this rank's count of global steps."""
    leaves = list(result.state) + [result.cost, result.initial_cost, result.lam, result.n_accepted]
    per = leaves[0].shape[0]
    flat = torch.cat([x.reshape(per, -1).to(torch.float32) for x in leaves], dim=1)
    full = gather_rows(mesh, PAIRS_AXIS, flat, "gather_pairs")
    b = full.shape[0]
    out, col = [], 0
    for x in leaves:
        w = x[0].numel() if x.ndim > 1 else 1
        out.append(full[:, col:col + w].reshape((b,) + tuple(x.shape[1:])).to(x.dtype))
        col += w
    state = type(result.state)(*out[:len(result.state)])
    cost, initial_cost, lam, n_accepted = out[len(result.state):]
    return lm_ops.LMResult(state=state, cost=cost, initial_cost=initial_cost, lam=lam,
                           n_accepted=n_accepted, n_solves=result.n_solves)


def solve_pairs_sharded(mesh: Mesh, cam_kind: str, data: D_.PairData, hyper: D_.Hyper, state0: D_.PairState,
                        n_iterations: int, spec: D_.ModelSpec = D_.ModelSpec()) -> lm_ops.LMResult:
    """``shard_pairs`` + ``deformable.solve_pairs`` on this rank's slice +
    ``gather_pairs``: JAX's ``solve_pairs`` on a pair-sharded batch. The
    backend follows the whole batch's size, as JAX dispatches on the global
    shape."""
    b = int(data.kp1.shape[0])
    d, s, h = shard_pairs(mesh, data, state0, hyper)
    res = D_.solve_pairs(cam_kind, d, h, s, n_iterations, spec, backend_batch=b)
    return gather_pairs(mesh, res)


def shard_pair(mesh: Mesh, data: D_.PairData, state: D_.PairState):
    """This rank's rows of every per-point tensor of one pair along the
    points axis (leading dim N), the rest replicated (``dist.py:116-128``)."""
    n = data.kp1.shape[0]
    S = mesh.axis_size(POINTS_AXIS)
    if n % S != 0:
        raise ValueError(f"landmark count {n} is not divisible by the {S}-rank '{POINTS_AXIS}' axis; "
                         f"pad the pair (halo.pad_pair)")

    def place(x):
        x = _to(x, mesh.device)
        return rows_of(mesh, POINTS_AXIS, x) if (x.ndim >= 1 and x.shape[0] == n) else x

    return type(data)(*(place(x) for x in data)), type(state)(*(place(x) for x in state))


def gather_state(mesh: Mesh, state: D_.PairState) -> D_.PairState:
    """The whole pair's state on every rank from each rank's rows."""
    pp = gather_rows(mesh, POINTS_AXIS, torch.cat([state.p1, state.p2], dim=-1), "gather_state")
    return state._replace(p1=pp[:, :3].contiguous(), p2=pp[:, 3:].contiguous())


def hessian_diag(cam_kind, data, hyper, state):
    """Exact diag(J^T J) from per-edge blocks (no dense H materialized)."""
    return D_.assemble_diag(cam_kind, data, hyper, state)


# The distributed result is the shared LMResult (one damping loop for every
# backend lives in ops/lm.py; this module only provides the sharded wiring).
DistLMResult = lm_ops.LMResult


class ShardedPair:
    """One rank's rows of a landmark-sharded pair and the exchanges its LM
    loop needs (``mesh``'s points axis, more than one rank).

    The rows' data keeps the global neighbour indices of ``nbr``; the whole
    pair's Ri and valid are exchanged once, its p1/p2 at every assembly and
    cost. The depth-scale prior is taken out of the rows' data and added
    once, after each reduction, on every rank alike."""

    def __init__(self, mesh: Mesh, cam_kind: str, data: D_.PairData, hyper: D_.Hyper, spec: D_.ModelSpec):
        self.mesh, self.cam_kind, self.hyper, self.spec = mesh, cam_kind, hyper, spec
        self.n_loc = int(data.kp1.shape[0])
        S = mesh.axis_size(POINTS_AXIS)
        self.n = S * self.n_loc
        self.lo = mesh.axis_index(POINTS_AXIS) * self.n_loc
        self.priors = ((data.s1_prior, data.s1_info), (data.s2_prior, data.s2_info))
        zero = torch.zeros_like(data.s1_info)
        self.data = data._replace(s1_info=zero, s2_info=zero)
        self.Ri_all = gather_rows(mesh, POINTS_AXIS, data.Ri, "setup")
        self.valid_all = gather_rows(mesh, POINTS_AXIS, data.valid.to(data.Ri.dtype), "setup") > 0.5
        self.scaled = spec.depth in ("scaled", "scaled_squared")

    def reduce(self, t, tag):
        return self.mesh.all_reduce(t, POINTS_AXIS, tag)

    def source(self, state) -> D_.NeighbourSource:
        pp = gather_rows(self.mesh, POINTS_AXIS, torch.cat([state.p1, state.p2], dim=-1), "gather_points")
        return D_.NeighbourSource(pp[:, :3], pp[:, 3:], self.Ri_all, self.valid_all)

    def cost(self, state):
        c = D_.robust_cost(self.cam_kind, self.data, self.hyper, state, self.spec, self.source(state))
        c = self.reduce(c.reshape(1).clone(), "cost")[0]
        if self.scaled:
            (p1, i1), (p2, i2) = self.priors
            c = c + (i1 * (state.s1 - p1) ** 2 + i2 * (state.s2 - p2) ** 2)
        return c

    def system(self, state):
        """This rank's rows of the block system, with the whole pair's Hg and
        g_g, and the whole diag's max."""
        sys = bs_.build_block_system(self.cam_kind, self.data, self.hyper, state, self.spec, self.source(state))
        S, i = self.mesh.axis_size(POINTS_AXIS), self.mesh.axis_index(POINTS_AXIS)
        maxes = torch.zeros(S, dtype=sys.D.dtype, device=sys.D.device)
        maxes[i] = torch.max(torch.diagonal(sys.D, dim1=-2, dim2=-1))
        red = self.reduce(torch.cat([sys.Hg.reshape(-1), sys.g_g, maxes]), "system")
        Hg, g_g = red[:64].reshape(8, 8).clone(), red[64:72].clone()
        if self.scaled:
            for col, (sc, (prior, info)) in enumerate(zip((state.s1, state.s2), self.priors)):
                Hg[col, col] += info
                g_g[col] += info * (sc - prior)
        diag_max = torch.maximum(torch.max(red[72:]), torch.max(torch.diagonal(Hg)))
        return sys._replace(Hg=Hg, g_g=g_g), diag_max

    def dot(self, a, b):
        """a . b of two tangents in the rows' flat layout [p1, p2 (6 n_loc), s1, s2, xi]."""
        m = 6 * self.n_loc
        part = self.reduce(torch.dot(a[:m], b[:m]).reshape(1), "lm_dot")[0]
        return part + torch.dot(a[m:], b[m:])

    def step(self, solve_factory):
        """LM step factory over this rank's rows; ``solve_factory(sys, lam)
        -> (x_p, x_g)`` is the sharded damped solve."""

        def make_step(state):
            sys, diag_max = self.system(state)
            g = bs_._join(sys.g_p, sys.g_g)
            return (lambda lam: bs_._join(*solve_factory(sys, lam))), g, diag_max

        return make_step



def sharded_pair(mesh: Mesh | None, cam_kind: str, data: D_.PairData, hyper: D_.Hyper,
                 spec: D_.ModelSpec) -> ShardedPair | None:
    """This rank's ``ShardedPair``; None without ``mesh`` or on a points
    axis of one rank, where (data) is the whole pair."""
    if mesh is None or mesh.axis_size(POINTS_AXIS) == 1:
        return None
    return ShardedPair(mesh, cam_kind, data, hyper, spec)


def optimize_rows(pair: ShardedPair | None, cam_kind: str, data: D_.PairData, hyper: D_.Hyper,
                  spec: D_.ModelSpec, make_step, state0: D_.PairState, n_iterations: int,
                  max_trials: int) -> lm_ops.LMResult:
    """The shared LM damping loop (``ops/lm.lm_optimize_general``) with
    ``make_step`` over this rank's rows: with a ``ShardedPair`` the cost and
    the gain ratio's dot product are summed over the ranks; without one
    they are the whole pair's."""
    if pair is None:
        cost, dot = (lambda s: D_.robust_cost(cam_kind, data, hyper, s, spec)), torch.dot
    else:
        cost, dot = pair.cost, pair.dot
    return lm_ops.lm_optimize_general(make_step, cost, D_.apply_delta, state0, n_iterations,
                                      max_trials=max_trials, dot=dot)


def pcg_sharded(sp: ShardedPair, sys: bs_.BlockSystem, lam, matvec, cg_iters: int, rtol: float):
    """Block-Jacobi PCG of (H + lam I) x = -g over this rank's rows (the
    schedule of ``halo.py:251-347``): ``matvec(v_p, v_g)`` makes one
    exchange; p.Ap is one all-reduce and (r.z, r.r) one more, whose r.r is
    the stop test every rank reads. The replicated global part (v_g) is
    added once, outside the sums. Returns (x_p, x_g)."""
    eye6 = torch.eye(6, dtype=sys.D.dtype, device=sys.D.device)
    Dinv = bs_.inv6_spd(sys.D + lam * eye6[None])
    Hginv = torch.linalg.inv(sys.Hg + lam * torch.eye(8, dtype=sys.Hg.dtype, device=sys.Hg.device))

    def pre(r_p, r_g):
        return torch.einsum("nab,nb->na", Dinv, r_p), Hginv @ r_g

    def dot(a_p, a_g, b_p, b_g):
        return sp.reduce(torch.sum(a_p * b_p).reshape(1), "pcg_dot")[0] + torch.dot(a_g, b_g)

    def dots_rz_rr(r_p, r_g, z_p, z_g):
        red = sp.reduce(torch.stack([torch.sum(r_p * z_p), torch.sum(r_p * r_p)]), "pcg_rz_rr")
        return red[0] + torch.dot(r_g, z_g), red[1] + torch.dot(r_g, r_g)

    x_p, x_g = torch.zeros_like(sys.g_p), torch.zeros_like(sys.g_g)
    r_p, r_g = -sys.g_p, -sys.g_g
    z_p, z_g = pre(r_p, r_g)
    p_p, p_g = z_p, z_g
    rz, rr = dots_rz_rr(r_p, r_g, z_p, z_g)
    tol2 = rtol * rtol * rr  # x0 = 0, so r0 = b and rr0 = b.b
    k = 0
    while k < cg_iters and bool(rr > tol2):
        Ap_p, Ap_g = matvec(p_p, p_g)
        alpha = rz / (dot(p_p, p_g, Ap_p, Ap_g) + TINY)
        x_p, x_g = x_p + alpha * p_p, x_g + alpha * p_g
        r_p, r_g = r_p - alpha * Ap_p, r_g - alpha * Ap_g
        z_p, z_g = pre(r_p, r_g)
        rz_new, rr = dots_rz_rr(r_p, r_g, z_p, z_g)
        beta = rz_new / (rz + TINY)
        p_p, p_g = z_p + beta * p_p, z_g + beta * p_g
        rz = rz_new
        k += 1
    COUNTS["cg_iterations"] += k
    COUNTS["pcg_solves"] += 1
    return x_p, x_g


def full_exchange_matvec(sp: ShardedPair, sys: bs_.BlockSystem, nbr: torch.Tensor, lam):
    """(H + lam I) v on this rank's rows: ONE all-reduce of the whole packed
    tangent [N, 6] (each rank's rows in a zero buffer) fused with the
    C^T v_p sum, then the neighbour contraction (``block_system.block_matvec``)."""
    n, lo, n_loc = sp.n, sp.lo, sp.n_loc
    j_safe = torch.clamp(nbr, min=0)

    def matvec(v_p, v_g):
        buf = v_p.new_zeros(6 * n + 8)
        buf[6 * lo:6 * (lo + n_loc)] = v_p.reshape(-1)
        buf[6 * n:] = torch.einsum("nag,na->g", sys.C, v_p)
        buf = sp.reduce(buf, "pcg_matvec")
        vj = buf[:6 * n].reshape(n, 6)[j_safe]
        y_p = (
            torch.einsum("nab,nb->na", sys.D, v_p)
            + torch.einsum("nkab,nkb->na", sys.Bt, vj)
            + torch.einsum("nag,g->na", sys.C, v_g)
            + lam * v_p
        )
        return y_p, buf[6 * n:] + sys.Hg @ v_g + lam * v_g

    return matvec


def solve_pair_distributed(
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state0: D_.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    spec: D_.ModelSpec = D_.ModelSpec(),
    mesh: Mesh | None = None,
) -> DistLMResult:
    """LM with block-sparse PCG inner solves (``dist.py:144-179``); the
    damping loop is the shared ``ops/lm.lm_optimize_general``.

    Without ``mesh``, or on a points axis of one rank, (data, state0) is the
    whole pair and the step is ``make_block_step`` (kernel 2 on the card).
    On more ranks they are this rank's rows from ``shard_pair``: the rows'
    system is assembled after the p1/p2 exchange and each PCG matvec
    exchanges the whole packed tangent (``full_exchange_matvec``); the
    returned state is this rank's rows (``gather_state`` gives the whole).
    """
    pair = sharded_pair(mesh, cam_kind, data, hyper, spec)
    if pair is None:
        make_step = bs_.make_block_step(cam_kind, data, hyper, spec, cg_iters, D_.CG_RTOL)
    else:
        make_step = pair.step(lambda sys, lam: pcg_sharded(
            pair, sys, lam, full_exchange_matvec(pair, sys, data.nbr, lam), cg_iters, D_.CG_RTOL))
    return optimize_rows(pair, cam_kind, data, hyper, spec, make_step, state0, n_iterations, max_trials)
