"""Levenberg-Marquardt with g2o-parity damping, as a host loop.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/lm.py:43-184``.
The JAX package runs the loop as ``lax.scan`` over iterations with a
``while_loop`` of trials; here both are Python loops. The (lambda, nu,
accept, stop) arithmetic stays on the device in f32, as in the JAX scan, and
each trial reads one boolean back to the host to take its branch:

- lambda0 = TAU * max(diag H);
- rho = (F0 - F1) / (delta . (lambda delta - g));
- accept (rho > 0 and F1 finite): lambda *= max(1/3, 1 - (2 rho - 1)^3),
  nu = 2; reject: lambda *= nu, nu *= 2; up to ``MAX_TRIALS`` trials;
- an iteration whose trials all fail ends the optimization.

``lm_optimize_flat_batched`` (``lm.py:187-267``) runs a batch of
independent problems with one batched damped solve per global step and the
same per-problem schedule. ``lm_optimize_speculative`` is not ported (no
caller in the JAX package uses it; ROADMAP, "do not port").
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..precision import TINY
from .damped_cholesky import (
    damped_solve_batched_cuda,
    damped_solve_cuda,
    solve_damped_cholesky_batched_plain,
    solve_damped_cholesky_plain,
)

# The JAX loop's defaults (lm.py:76-77 of the JAX package), which no caller
# there overrides: initial damping relative to max(diag H), and trials per
# iteration before the optimization stops.
TAU = 1e-5
MAX_TRIALS = 10


def solve_damped_cholesky(H, g, lam):
    """Solve (H + lam I) x = -g by equilibrated Cholesky + one refinement.

    A CUDA tensor goes to the hand-written kernel (``damped_solve_cuda``,
    which raises if it cannot launch); a CPU tensor to the plain version.
    """
    if H.device.type == "cuda":
        return damped_solve_cuda(H, g, lam)
    if H.device.type != "cpu":
        raise ValueError(f"no damped solve for device {H.device}")
    return solve_damped_cholesky_plain(H, g, lam)


def solve_damped_cholesky_batched(H, g, lam):
    """The damped solve of every system of a batch, H [B, n, n], g [B, n],
    lam [B]: a CUDA tensor goes to one launch of the kernel's batched entry
    (``damped_solve_batched_cuda``), a CPU tensor to the plain version
    system by system."""
    if H.device.type == "cuda":
        return damped_solve_batched_cuda(H, g, lam)
    if H.device.type != "cpu":
        raise ValueError(f"no damped solve for device {H.device}")
    return solve_damped_cholesky_batched_plain(H, g, lam)


class LMResult(NamedTuple):
    state: object
    cost: torch.Tensor
    initial_cost: torch.Tensor
    lam: torch.Tensor
    # An int; a tensor [B] from lm_optimize_flat_batched.
    n_accepted: object
    # Damped solves this run made (one per trial; the global steps of
    # lm_optimize_flat_batched, each one batched solve); the JAX scan does
    # not report it, the port's measurement scripts read it.
    n_solves: int = 0


def lm_optimize_general(
    make_step: Callable,
    robust_cost: Callable,
    apply_delta: Callable,
    state0,
    n_iterations: int,
    max_trials: int = MAX_TRIALS,
    dot: Callable = torch.dot,
) -> LMResult:
    """The LM damping loop (``lm.py:71-150``).

    ``make_step(state) -> (solve, g, diag_max)`` linearizes at ``state``;
    ``solve(lam) -> delta`` is the damped solve. ``dot`` is the gain
    ratio's inner product of two tangents: a landmark-sharded solve passes
    one that sums over every rank (``parallel/dist.py``), so that every rank
    reads the same accept decision.
    """
    F0_init = robust_cost(state0)
    state, F = state0, F0_init
    lam = torch.full((), -1.0, dtype=F.dtype, device=F.device)
    nu = torch.full((), 2.0, dtype=F.dtype, device=F.device)
    n_accepted = 0
    n_solves = 0
    for _ in range(n_iterations):
        solve, g, diag_max = make_step(state)
        lam = torch.where(lam < 0, TAU * diag_max, lam)
        accepted = False
        for _ in range(max_trials):
            delta = solve(lam)
            n_solves += 1
            cand = apply_delta(state, delta)
            F1 = robust_cost(cand)
            scale = dot(delta, lam * delta - g) + TINY
            rho = (F - F1) / scale
            ok_t = (rho > 0) & torch.isfinite(F1)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            ok = bool(ok_t)
            if ok:
                lam = lam * factor
                nu = torch.full_like(nu, 2.0)
                state, F = cand, F1
                accepted = True
                break
            lam = lam * nu
            nu = 2.0 * nu
        if not accepted:
            break
        n_accepted += 1
    return LMResult(
        state=state, cost=F, initial_cost=F0_init, lam=lam,
        n_accepted=n_accepted, n_solves=n_solves,
    )


def lm_optimize(
    build_system: Callable,
    robust_cost: Callable,
    apply_delta: Callable,
    state0,
    n_iterations: int,
) -> LMResult:
    """Dense-normal-equation LM, ``build_system(state) -> (H, g)``
    (``lm.py:153-184``): one damped solve per trial."""

    def make_step(state):
        H, g = build_system(state)
        return (lambda lam: solve_damped_cholesky(H, g, lam)), g, torch.max(torch.diagonal(H))

    return lm_optimize_general(make_step, robust_cost, apply_delta, state0, n_iterations)


def unstack(tree) -> list:
    """The members of a batched tensor, or of a tuple of batched tensors (a
    NamedTuple keeps its type): the leading axis of every leaf."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [type(tree)(*col) for col in zip(*(unstack(f) for f in tree))]


def stack(trees: list):
    """Inverse of ``unstack``: members stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(stack(list(col)) for col in zip(*trees)))


def _select(ok: torch.Tensor, new, old):
    """Per member: ``new`` where ``ok``, else ``old`` (tensors or tuples)."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
    return type(new)(*(_select(ok, a, b) for a, b in zip(new, old)))


def lm_optimize_flat_batched(
    make_step_batched: Callable,
    robust_cost_batched: Callable,
    apply_delta: Callable,
    state0,
    batch: int,
    n_iterations: int,
) -> LMResult:
    """LM for a batch of independent problems (``lm.py:187-267``).

    Each global step linearizes every problem once, makes ONE batched damped
    solve and ONE batched cost evaluation; acceptance and damping evolve per
    problem. A rejection leaves that problem's state in place while its
    lambda grows, so relinearizing there gives the linear system that
    ``lm_optimize_general``'s trial loop reuses: per problem, the (lambda,
    nu, accept) schedule is the sequential one. A problem stops after
    ``MAX_TRIALS`` rejections in a row or ``n_iterations`` acceptances; the
    loop ends when none is left or after ``n_iterations * MAX_TRIALS``
    steps.

    ``make_step_batched(state_b) -> (solve_b, g_b, diag_max_b)`` with
    ``solve_b(lam_b [B]) -> delta_b [B, dim]``;
    ``robust_cost_batched(state_b) -> [B]``; ``apply_delta`` maps one
    problem (it is applied member by member). The per-problem arithmetic
    stays on the device; the host reads one boolean per global step (is any
    problem left), where ``lm_optimize_general`` reads one per trial. The
    gain ratio's denominator is a dot product per problem, as in
    ``lm_optimize_general``, so a problem whose solve, gradient and costs
    are its single-problem values takes the single-problem schedule bit for
    bit.
    """
    F0_init = robust_cost_batched(state0)
    dt, dev = F0_init.dtype, F0_init.device

    def apply_b(state_b, delta):
        return stack([apply_delta(s, d) for s, d in zip(unstack(state_b), delta.unbind(0))])

    state, F = state0, F0_init
    lam = torch.full((batch,), -1.0, dtype=dt, device=dev)
    nu = torch.full((batch,), 2.0, dtype=dt, device=dev)
    n_acc = torch.zeros(batch, dtype=torch.int32, device=dev)
    streak = torch.zeros(batch, dtype=torch.int32, device=dev)
    stop = torch.zeros(batch, dtype=torch.bool, device=dev)
    max_steps = n_iterations * MAX_TRIALS
    k = 0
    while k < max_steps:
        alive = ~stop & (n_acc < n_iterations)
        if not bool(alive.any()):
            break
        solve_b, g_b, diag_max_b = make_step_batched(state)
        lam0 = torch.where(lam < 0, TAU * diag_max_b, lam)
        delta = solve_b(lam0)
        cand = apply_b(state, delta)
        F1 = robust_cost_batched(cand)
        scale = torch.stack([torch.dot(d, l * d - g) for d, l, g in zip(delta, lam0, g_b)]) + TINY
        rho = (F - F1) / scale
        ok = (rho > 0) & torch.isfinite(F1) & alive
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(ok, lam0 * factor, torch.where(alive, lam0 * nu, lam))
        nu = torch.where(ok, torch.full_like(nu, 2.0), torch.where(alive, 2.0 * nu, nu))
        state = _select(ok, cand, state)
        F = torch.where(ok, F1, F)
        n_acc = n_acc + ok.to(torch.int32)
        streak = torch.where(ok, torch.zeros_like(streak), torch.where(alive, streak + 1, streak))
        stop = stop | (streak >= MAX_TRIALS)
        k += 1
    return LMResult(
        state=state, cost=F, initial_cost=F0_init, lam=lam, n_accepted=n_acc, n_solves=k,
    )
