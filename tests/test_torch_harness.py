"""The port's sweep harness (harness/sweep.py, harness/aggregate.py and the
``run_experiments`` entry point) against the JAX package's.

Same conditions, the same base ``Config`` (``harness/sweep_config.sweep_config``,
the reference's ``Simulation.yaml`` is not in the repository) and the same
seed through both packages on the CPU, at the budget of
``tests/test_harness.py:59-61`` (1 round x 2 search evaluations x 8 LM
iterations). The fixtures are generated (``database_root=None``) from one
shared rng as the sweep draws them, but with 60 points instead of
``create_data``'s 240: both packages' ``generate_points`` get
``num_points=60`` for these runs, which keeps each run to seconds on one
CPU thread (240 points take about a minute a run here). Tolerances:

- layouts, tables and generated fixtures: equal;
- initial mean 3D error: 1e-6 m (the same f32 triangulation);
- final mean 3D error: 5e-7 m, the limit of ``test_torch_pipeline.py`` (the
  weight search's decisions agree step for step);
- the CSV tables: byte for byte on the same journals.

Run as a script, it prints the values that ``chip_smoke.py`` holds the
port's sweep to: the two conditions above at the sweep's full budget (5
rounds x 8 evaluations x 25 LM iterations) and ``create_data``'s 240
points, through the JAX package on the CPU, or with ``--port`` through the
port on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_harness.py [--port]
"""

import dataclasses
import filecmp
import functools
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.harness import aggregate as t_agg
from triangulation_in_deformable_scenes_torch.harness import sweep as t_sweep
from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
from triangulation_in_deformable_scenes_torch.utils.journal import parse_journal
from triangulation_in_deformable_scenes_tpu.config import Config as JConfig
from triangulation_in_deformable_scenes_tpu.harness import aggregate as j_agg
from triangulation_in_deformable_scenes_tpu.harness import sweep as j_sweep

torch.set_num_threads(1)

MODEL, TRI, DEPTH, SHAPE, EXP = "ARAP_depth_3mm", "InRays", 20, "Planar", 2
TYPES = (2, 5)


def _base():
    return dataclasses.replace(sc.sweep_config(), n_optimizations=1, n_opt_iterations=8, nlopt_n_optimizations=2)


def _conds(mod):
    return [mod.SweepCondition(MODEL, TRI, DEPTH, SHAPE, t, EXP) for t in TYPES]


@pytest.fixture(scope="module")
def sixty_points():
    """Both packages' sweeps generate 60-point fixtures (see the docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_sweep, j_sweep):
            mp.setattr(mod.create_data, "generate_points",
                       functools.partial(mod.create_data.generate_points, num_points=60))
        yield


def test_tables_equal_jax():
    for name in ("CAMERA_POSES", "EXPERIMENT_TYPES", "SHAPE_EXPERIMENT_TYPES", "SEED_ALIASES"):
        assert getattr(t_sweep, name) == getattr(j_sweep, name), name


@pytest.mark.parametrize("depth", [20, 80, 150])
def test_layouts_equal_jax(depth):
    for shape, types in j_sweep.SHAPE_EXPERIMENT_TYPES.items():
        for etype in types:
            for model, tri in (("ARAP", "InRays"), ("ARAP_depth_8mm", "FarPoints")):
                tc = t_sweep.SweepCondition(model, tri, depth, shape, etype, 3)
                jc = j_sweep.SweepCondition(model, tri, depth, shape, etype, 3)
                assert tc.result_dir == jc.result_dir
                assert tc.fixture_dir == jc.fixture_dir
                p = j_sweep.EXPERIMENT_TYPES[etype]
                assert t_sweep.movement_dirname(p["gaussian"], p["rigid"]) == j_sweep.movement_dirname(
                    p["gaussian"], p["rigid"])


def test_fixtures_from_one_shared_rng_equal_jax(tmp_path):
    """Three generated conditions from one rng per package: the same points
    in the same order; a condition with a fixture on disk draws nothing."""
    conds = [(2, "Planar", 20), (6, "Gradual", 80), (4, "Planar", 150)]
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    for etype, shape, depth in conds:
        _, _, gt = t_sweep._fixture_points(t_sweep.SweepCondition("ARAP", "InRays", depth, shape, etype, 1), None, rt)
        _, _, gj = j_sweep._fixture_points(j_sweep.SweepCondition("ARAP", "InRays", depth, shape, etype, 1), None, rj)
        np.testing.assert_array_equal(gt[0], gj[0])
        np.testing.assert_array_equal(gt[1], gj[1])
    cond = t_sweep.SweepCondition("ARAP", "InRays", 20, "Planar", 2, 1)
    d = tmp_path / cond.fixture_dir
    d.mkdir(parents=True)
    for f in ("original_points.csv", "moved_points.csv"):
        (d / f).write_text("0,0,0\n")
    state = rt.bit_generator.state
    of, mf, gen = t_sweep._fixture_points(cond, str(tmp_path), rt)
    assert gen is None and of == str(d / "original_points.csv") and mf == str(d / "moved_points.csv")
    assert rt.bit_generator.state == state


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory, sixty_points):
    root = tmp_path_factory.mktemp("sweeps")
    out_j, out_t = str(root / "jax"), str(root / "torch")
    base = _base()
    rj = j_sweep.run_sweep(JConfig(**dataclasses.asdict(base)), _conds(j_sweep), out_j, seed=0,
                           mesh_backend=sc.MESH_BACKEND)
    rt = t_sweep.run_sweep(base, _conds(t_sweep), out_t, seed=0, mesh_backend=sc.MESH_BACKEND, device="cpu")
    return root, out_j, out_t, rj, rt


def test_run_sweep_matches_jax(sweeps):
    _, out_j, out_t, rj, rt = sweeps
    assert len(rt) == len(rj) == len(TYPES)
    for (ct, t), (cj, j) in zip(rt, rj):
        assert ct.result_dir == cj.result_dir
        assert os.path.exists(os.path.join(out_t, ct.result_dir, "Experiment.txt"))
        np.testing.assert_array_equal(t.valid, j.valid)
        assert int(t.valid.sum()) > 50
        assert abs(t.initial.av_error - j.initial.av_error) < 1e-6
        assert np.isfinite(t.final.av_error)
        assert abs(t.final.av_error - j.final.av_error) < 5e-7, (t.final.av_error, j.final.av_error)
        assert t.rounds == j.rounds
        np.testing.assert_allclose(t.weights, j.weights, rtol=1e-6)


def test_condition_csv_byte_identical(sweeps):
    root, out_j, out_t, _, _ = sweeps
    for src in (out_j, out_t):
        a = t_agg.write_condition_csv(str(root / "t.csv"), src, [MODEL], [TRI], shapes=[SHAPE], depth_cm=DEPTH,
                                      experiment=EXP)
        b = j_agg.write_condition_csv(str(root / "j.csv"), src, [MODEL], [TRI], shapes=[SHAPE], depth_cm=DEPTH,
                                      experiment=EXP)
        assert filecmp.cmp(a, b, shallow=False)
    rows = open(a).read().splitlines()
    assert rows[0].startswith("Avg Movement,Shape,Gaussian Mov,Rigid Mov,ARAP_depth_3mm-InRays Initial (mm)")
    assert len(rows) == 1 + len(TYPES)
    for etype, line in zip(TYPES, rows[1:]):
        cond = t_sweep.SweepCondition(MODEL, TRI, DEPTH, SHAPE, etype, EXP)
        r = t_agg.journal_to_row(os.path.join(out_t, cond.result_dir, "Experiment.txt"))
        assert f'"{t_agg._fmt(r["initial"])}","{t_agg._fmt(r["final"])}"' in line


def test_comparison_csv_byte_identical(sweeps):
    root, out_j, out_t, _, _ = sweeps
    kw = dict(models=[MODEL], triangulations=[TRI], shapes=[SHAPE], depth_cms=[DEPTH], experiment_types=TYPES,
              experiments=[EXP])
    pt, nt, wt = t_agg.write_comparison_csv(str(root / "ct.csv"), out_t, out_j, **kw)
    pj, nj, wj = j_agg.write_comparison_csv(str(root / "cj.csv"), out_t, out_j, **kw)
    assert (nt, wt) == (nj, wj) and nt == len(TYPES)
    assert filecmp.cmp(pt, pj, shallow=False)


def test_journal_to_row_equal_jax(sweeps):
    _, out_j, out_t, _, _ = sweeps
    for out in (out_j, out_t):
        for cond in _conds(t_sweep):
            p = os.path.join(out, cond.result_dir, "Experiment.txt")
            assert t_agg.journal_to_row(p) == j_agg.journal_to_row(p)


def test_run_experiments_cli_on_cpu(tmp_path, sixty_points):
    """The entry point with ``--device cpu``: one condition, one round of one
    evaluation, its journal and its CSV."""
    from triangulation_in_deformable_scenes_torch import run_experiments

    out, csv = tmp_path / "exps", tmp_path / "errors.csv"
    run_experiments.main(["--model", MODEL, "--triangulation", TRI, "--depth", "20", "--shape", SHAPE,
                          "--types", "2", "--experiment", "2", "--rounds", "1", "--nlopt-evals", "1",
                          "--out", str(out), "--csv", str(csv), "--device", "cpu"])
    cond = t_sweep.SweepCondition(MODEL, TRI, 20, SHAPE, 2, 2)
    blocks = parse_journal(str(out / cond.result_dir / "Experiment.txt"))
    assert list(blocks)[:2] == ["HEADER", "INITIAL"] and list(blocks)[-1] == "FINAL"
    assert np.isfinite(blocks["FINAL"]["Av. error"])
    rows = csv.read_text().splitlines()
    assert len(rows) == 2 and rows[1].split('"')[1] != ""


def test_run_experiments_defaults_to_the_card(tmp_path):
    from triangulation_in_deformable_scenes_torch import run_experiments

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiments.main(["--types", "2", "--rounds", "1", "--nlopt-evals", "1", "--out", str(tmp_path)])


@pytest.mark.cuda
def test_run_sweep_on_card_matches_jax(sweeps, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, _, _, rj, _ = sweeps
    rc = t_sweep.run_sweep(_base(), _conds(t_sweep), str(tmp_path), seed=0, mesh_backend=sc.MESH_BACKEND,
                           device="cuda")
    for (_, c), (_, j) in zip(rc, rj):
        np.testing.assert_array_equal(c.valid, j.valid)
        assert abs(c.initial.av_error - j.initial.av_error) < 1e-6
        assert abs(c.final.av_error - j.final.av_error) <= 0.02 * j.final.av_error


def _main(argv):
    import argparse
    import json
    import tempfile
    import time

    ap = argparse.ArgumentParser(description="Reference values of the sweep's two conditions at full budget")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU instead of the JAX package")
    args = ap.parse_args(argv)
    base = sc.sweep_config()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        if args.port:
            out = t_sweep.run_sweep(base, _conds(t_sweep), tmp, seed=0, mesh_backend=sc.MESH_BACKEND, device="cpu")
        else:
            out = j_sweep.run_sweep(JConfig(**dataclasses.asdict(base)), _conds(j_sweep), tmp, seed=0,
                                    mesh_backend=sc.MESH_BACKEND)
    for cond, res in out:
        print(json.dumps(dict(type=cond.experiment_type, n_valid=int(res.valid.sum()),
                              initial_av_error_m=float(res.initial.av_error),
                              final_av_error_m=float(res.final.av_error), rounds=res.rounds,
                              weights=np.asarray(res.weights).tolist())))
    print(json.dumps({"package": "port (cpu)" if args.port else "jax (cpu)", "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    _main(sys.argv[1:])
