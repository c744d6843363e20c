"""The Ogden cell's check on the CPU, at a tiny size: a cell of the
``sweep_energy`` kind added by files and entries alone comes out correct,
and not correct when the program's energy is wrong underneath (ARAP's
energy in place of Ogden's; Ogden's lambda^(-alpha beta) term dropped). The
limits are ``ogden240.sweep``'s own. The new modules import nothing of JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY, run_cpu


@pytest.fixture(scope="module")
def ogden_root(tmp_path_factory):
    """A checkout of the benchmark alone with ``tiny_ogden.sweep_energy``:
    ``ogden240`` at the tiny size, under ``ogden240.sweep``'s limits."""
    root = tmp_path_factory.mktemp("ogden_root")
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads((root / "port_bench" / "configs" / "ogden240.json").read_text())
    (root / "port_bench" / "configs" / "tiny_ogden.json").write_text(json.dumps(dict(cfg, **TINY, name="tiny_ogden")))
    limits = root / "port_bench" / "limits"
    shutil.copy(limits / "ogden240.sweep.json", limits / "tiny_ogden.sweep_energy.json")
    bench["configs"].append({"name": "tiny_ogden", "source": "test", "file": "port_bench/configs/tiny_ogden.json",
                             "reduced": ["num_points"], "why": "test"})
    bench["workloads"].append({"name": "tiny_ogden.sweep_energy", "config": "tiny_ogden", "traffic": "sweep_energy",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny_ogden.sweep_energy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _arap_in_place_of_ogden(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable

    monkeypatch.setitem(deformable.MODELS, "HyperElasticOdgen", deformable.ModelSpec())


def _inverse_term_dropped(monkeypatch):
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.precision import TINY as EPS

    edge0 = deformable._mesh_edge_energy

    def edge(spec, p1i, p2i, p1j, p2j, Ri, Rj, w, area, Rg, tg, alpha, beta):
        e = edge0(spec, p1i, p2i, p1j, p2j, Ri, Rj, w, area, Rg, tg, alpha, beta)
        l1 = torch.sqrt(torch.sum((p1i - p1j) ** 2, dim=-1) + EPS)
        l2 = torch.sqrt(torch.sum((p2i - p2j) ** 2, dim=-1) + EPS)
        alpha, beta = torch.as_tensor(alpha, dtype=l1.dtype), torch.as_tensor(beta, dtype=l1.dtype)
        term = (l2 / l1) ** (-alpha * beta) / torch.clamp(alpha, min=1e-6)
        return e - w * term * (l1 / area) ** 2

    monkeypatch.setattr(deformable, "_mesh_edge_energy", edge)


def test_ogden_cell_runs_and_is_correct(ogden_root, capsys):
    out = run_cpu(ogden_root, "tiny_ogden.sweep_energy", 2**31 + 9, 2, capsys)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_ms", "setup_s"}
    with open(os.path.join(ROOT, "port_bench", "limits", "ogden240.sweep.json")) as f:
        assert list(out["checks"]) == list(json.load(f)["limits"])


@pytest.mark.parametrize("fault", [_arap_in_place_of_ogden, _inverse_term_dropped])
def test_wrong_energy_is_not_correct(ogden_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    out = run_cpu(ogden_root, "tiny_ogden.sweep_energy", 21, 2, capsys)
    assert out["correct"] is False


def test_other_parameters_are_refused():
    from port_bench.drivers import sweep_energy

    cfg = json.load(open(os.path.join(ROOT, "port_bench", "configs", "ogden240.json")))
    with pytest.raises(ValueError, match="passes 1 and 1"):
        sweep_energy._refuse_other_parameters(dict(cfg, beta=2.0))


def test_nothing_of_jax_is_imported():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from port_bench import bench\n"
        "from port_bench.drivers import sweep_energy\n"
        "from port_bench.reference import energies\n"
        "for m in ('mesh_jacobian_ms.sweep', 'mesh_energy_ms.sweep'):\n"
        "    bench.reader(bench.os.path.dirname(bench.HERE), m)\n"
        "import triangulation_in_deformable_scenes_torch.pipeline.simulation\n"
        "print(','.join(bench.forbidden_loaded()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
