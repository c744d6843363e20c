"""A run whose timed path is broken underneath comes out not correct: one
run of a tiny cell on the CPU for each fault the cell can have (a solve
that returns its state unchanged; half of the batch left out; an answer
altered where it is produced: one point set of an inner solve's result
moved by 1 cm). The cells run on one card, so there is no
exchange between cards to leave out. The limits are the full-size cells'."""

import pytest
import torch

from conftest import run_cpu


def _unchanged_solve_pair(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable

    solve0 = deformable.solve_pair

    def solve(cam_kind, data, hyper, state0, *args, **kwargs):
        return solve0(cam_kind, data, hyper, state0, *args, **kwargs)._replace(state=state0)

    monkeypatch.setattr(deformable, "solve_pair", solve)


def _altered_solve_pair(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable

    solve0 = deformable.solve_pair

    def solve(*args, **kwargs):
        res = solve0(*args, **kwargs)
        return res._replace(state=res.state._replace(p2=res.state.p2 + torch.tensor([0.0, 0.0, 0.01])))

    monkeypatch.setattr(deformable, "solve_pair", solve)


def _unchanged_batch(monkeypatch):
    from triangulation_in_deformable_scenes_torch.ops import lm

    opt0 = lm.lm_optimize_flat_batched

    def opt(make_step, cost, apply, state0, batch, n_iterations):
        return opt0(make_step, cost, apply, state0, batch, n_iterations)._replace(state=state0)

    monkeypatch.setattr(lm, "lm_optimize_flat_batched", opt)


def _half_batch(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    solve0 = deformable.solve_pairs

    def solve(cam_kind, data, hyper, state0, n_iterations, spec=deformable.ModelSpec(), backend_batch=None):
        B = int(data.kp1.shape[0])
        h = B // 2
        part = lambda tree, s: lm.stack(lm.unstack(tree)[s])
        res = solve0(cam_kind, part(data, slice(0, h)), hyper, part(state0, slice(0, h)), n_iterations, spec)
        rest = lm.unstack(state0)[h:]
        return res._replace(state=lm.stack(lm.unstack(res.state) + rest),
                            cost=torch.cat([res.cost, torch.full((B - h,), float(res.cost.mean()))]))

    monkeypatch.setattr(deformable, "solve_pairs", solve)


def _altered_batch(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable

    solve0 = deformable.solve_pairs

    def solve(*args, **kwargs):
        res = solve0(*args, **kwargs)
        p2 = res.state.p2.clone()
        p2[0, :, 2] += 0.01
        return res._replace(state=res.state._replace(p2=p2))

    monkeypatch.setattr(deformable, "solve_pairs", solve)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.sweep", _unchanged_solve_pair),
    ("tiny.sweep", _altered_solve_pair),
    ("tiny.batch3", _unchanged_batch),
    ("tiny.batch3", _half_batch),
    ("tiny.batch3", _altered_batch),
])
def test_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_cpu(tiny_root, workload, 21, 8 if "batch" in workload else 2, capsys)
    assert out["correct"] is False
