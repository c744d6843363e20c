"""The slice as a whole: both packages' ``SimulationPipeline`` on the same
reduced sweep fixture (60 points, 2 rounds x 5 search evaluations x 10 LM
iterations, seed 0, scipy mesh), the port on ``device="cpu"``.

Tolerances: the initial mean 3D error comes from the same f32 triangulation
in both packages (1e-6 m asked, ~1e-10 m seen); the final one follows
about 570 f32 LM solves through the weight search, whose decisions agree
step for step on this fixture (5e-7 m asked, ~1e-8 m seen).
"""

import numpy as np
import pytest
import torch

from test_torch_problems import run_pipeline
from triangulation_in_deformable_scenes_torch.utils.journal import parse_journal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    rj, jj = run_pipeline("jax", 60, 0, 2, 5, 10, tmp)
    rt, jt = run_pipeline("torch", 60, 0, 2, 5, 10, tmp, device="cpu")
    return rj, jj, rt, jt


def test_same_valid_points_and_initial_error(runs):
    rj, _, rt, _ = runs
    assert int(rt.valid.sum()) == int(rj.valid.sum()) == 60
    np.testing.assert_array_equal(rt.valid, rj.valid)
    assert abs(rt.initial.av_error - rj.initial.av_error) < 1e-6
    assert abs(rt.initial.rmse - rj.initial.rmse) < 1e-6
    assert abs(rt.initial.av_movement - rj.initial.av_movement) < 1e-9


def test_same_rounds_weights_and_final_error(runs):
    rj, _, rt, _ = runs
    assert rt.rounds == rj.rounds
    np.testing.assert_allclose(rt.weights, rj.weights, rtol=1e-6)
    assert np.isfinite(rt.final.av_error)
    assert abs(rt.final.av_error - rj.final.av_error) < 5e-7
    assert rt.rigid_accepted == bool(getattr(rj, "rigid_accepted", rt.rigid_accepted))


def test_journal_blocks_parse_alike(runs):
    """The port's journal has the JAX journal's blocks and fields, and its
    numbers agree to the journal's 6 significant digits where the maps
    agree (the header and the initial block)."""
    _, jj, _, jt = runs
    bj, bt = parse_journal(jj), parse_journal(jt)
    assert list(bt) == list(bj) == ["HEADER", "INITIAL", "1 / 2", "FINAL"]
    for name in bj:
        assert set(bt[name]) == set(bj[name]), name
    for key, val in bj["HEADER"].items():
        assert bt["HEADER"][key] == pytest.approx(val, rel=1e-5), key
    for key in ("Av. movement", "Av. error", "RMSE"):
        assert bt["INITIAL"][key] == pytest.approx(bj["INITIAL"][key], rel=1e-5), key
        assert bt["FINAL"][key] == pytest.approx(bj["FINAL"][key], rel=1e-4), key
