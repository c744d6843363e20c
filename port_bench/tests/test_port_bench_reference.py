"""The frozen reference against the port on the CPU, at a tiny size: one
whole sweep condition (30 points, one round) and a batch of three first
inner solves."""

import json
import os

import numpy as np
import torch

from conftest import ROOT, TINY


def _cfg_traffic(traffic):
    with open(os.path.join(ROOT, "port_bench", "configs", "syn240.json")) as f:
        cfg = dict(json.load(f), **TINY)
    with open(os.path.join(ROOT, "port_bench", "traffic", traffic)) as f:
        return cfg, json.load(f)


def test_reference_follows_the_port_through_a_condition(tmp_path):
    from port_bench import gen
    from port_bench.drivers import sweep
    from port_bench.reference import pipeline
    from triangulation_in_deformable_scenes_torch.models import deformable, outer

    torch.set_num_threads(2)
    cfg, traffic = _cfg_traffic("sweep.json")
    for seed in (3, 2**31 + 17):
        cond = gen.conditions(cfg, traffic, seed, 1)[0]
        files = gen.write_fixture(str(tmp_path), cond)
        seen = {}
        optimize0, solve0 = outer.deformation_optimization, deformable.solve_pair

        def optimize(*args, **kwargs):
            seen["x"] = (args[8], args[9])
            return optimize0(*args, **kwargs)

        def solve(*args, **kwargs):
            res = solve0(*args, **kwargs)
            seen.setdefault("first", res.state)
            return res

        outer.deformation_optimization, deformable.solve_pair = optimize, solve
        try:
            res = sweep.run_condition(cfg, torch.device("cpu"), cond, files)
        finally:
            outer.deformation_optimization, deformable.solve_pair = optimize0, solve0
        ref = pipeline.run_condition(cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed, torch.device("cpu"))
        assert ref.inner_solves == res.stats.inner_solves and ref.rounds == res.rounds
        assert ref.rigid_accepted == res.rigid_accepted
        got = sweep.numbers((*seen["x"], seen["first"], res.state, np.asarray(res.weights), res.rounds), ref, cond)
        assert got["valid_diff"] == 0 and got["rounds_diff"] == 0 and got["weight_gap_log10"] == 0
        assert got["init_gap_m"] <= 1e-9 and got["first_gap_m"] <= 1e-7
        assert got["final_gap_m"] <= 1e-7 and got["final_err_rel"] <= 1e-6


def test_reference_follows_the_port_through_a_batch():
    from port_bench import gen
    from port_bench.drivers import batch
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    torch.set_num_threads(2)
    cfg, traffic = _cfg_traffic("batch16.json")
    conds = gen.conditions(cfg, traffic, 5, 3)
    pairs = [batch.program_pair(cfg, torch.device("cpu"), c) for c in conds]
    data, state = lm.stack([d for d, _ in pairs]), lm.stack([s for _, s in pairs])
    rep, arap, sigma = batch.start_weights(cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    hyper = deformable.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma), global_w=f(1.0), alpha=f(1.0),
                             beta=f(1.0))
    res = deformable.solve_pairs("KB8", data, hyper, state, cfg["lm_iterations"], deformable.MODELS[cfg["model"]])
    got = batch.numbers(batch.program_pairs(state, res), batch.reference_pairs(cfg, conds, torch.device("cpu")))
    assert got["init_gap_m"] <= 1e-9 and got["final_gap_m"] <= 1e-7 and got["final_cost_rel"] <= 1e-6
