"""The benchmark's harness on the CPU: cells from files alone, no JAX, the
roofline arithmetic, and no result without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, run_cpu


def test_cell_added_by_files_and_entries_runs(tiny_root, capsys):
    sweep = run_cpu(tiny_root, "tiny.sweep", 2**31 + 5, 3, capsys)
    assert sweep["correct"] and sweep["attempted"] > 0 and sweep["failed"] == 0
    assert set(sweep["metrics"]) == {"solve_ms", "setup_s"}
    assert list(sweep["checks"]) == list(json.load(open(os.path.join(ROOT, "port_bench/limits/syn240.sweep.json")))["limits"])
    batch = run_cpu(tiny_root, "tiny.batch3", 11, 8, capsys)
    assert batch["correct"] and batch["attempted"] % 3 == 0 and batch["attempted"] > 0
    assert set(batch["metrics"]) == {"batch_pairs_per_s", "setup_s"}
    assert list(batch) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_nothing_of_jax_is_imported():
    code = (
        "import glob, importlib, os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from port_bench import bench, control, gen, roofline, run, trace\n"
        "from port_bench.drivers import batch, sweep\n"
        "from port_bench.reference import geometry, mesh, pipeline, solver\n"
        "for f in glob.glob(os.path.join(bench.HERE, 'metrics', '*.py')):\n"
        "    bench.reader(os.path.dirname(bench.HERE), os.path.basename(f)[:-3])\n"
        "import triangulation_in_deformable_scenes_torch.pipeline.simulation\n"
        "print(','.join(bench.forbidden_loaded()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    from port_bench import bench

    for name in ("jaxtyping", "triangulation_in_deformable_scenes_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "triangulation_in_deformable_scenes_tpu.ops", types.ModuleType("x"))
    assert bench.forbidden_loaded() == ["jax", "triangulation_in_deformable_scenes_tpu"]


def test_roofline_matches_the_kernel_table():
    from port_bench import roofline

    # chip_smoke.bound(1448): 0.0154 ms, operations-bound.
    assert abs(roofline.damped_solve_s(1448) * 1e3 - 0.0154) < 5e-5
    assert abs(roofline.damped_solve_s(2591) * 1e3 - 0.0875) < 5e-4
    # Batched entry: B times the single system (16 x 1448: 0.247 ms).
    assert roofline.damped_solve_batched_s(16, 1448) == 16 * roofline.damped_solve_s(1448)
    assert abs(roofline.damped_solve_batched_s(16, 1448) * 1e3 - 0.247) < 1e-3
    # Kernel 2 at 861 points, K = 32 (dim 5174): 0.00135 ms, bytes-bound.
    assert abs(roofline.block_pcg_s(861, 32) * 1e3 - 0.00135) < 1e-5


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "port_bench", "run.py"), "--workload", "syn240.sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        assert os.path.exists(os.path.join(ROOT, "port_bench", "metrics", f"{m['name']}.py"))
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "port_bench", "limits", f"{w['name']}.json"))
        assert os.path.exists(os.path.join(ROOT, "port_bench", "traffic", f"{w['traffic']}.json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
