"""Settings of the benchmark's own tests (``python -m pytest port_bench/tests``).

Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_card`` fixture, which skips them where no card is visible. The
decision is made inside the fixture, never while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")


# A tiny configuration of each kind of cell, added as files and entries only:
# 30 points, one round of two search evaluations, the full 25 LM iterations
# (so that an inner solve moves its points as far as at full size); the
# batch has three pairs. Their limits are the full-size cells' own.
TINY = {"num_points": 30, "rounds": 1, "nm_evaluations": 2, "lm_iterations": 25}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout of the benchmark alone with two cells added by files and
    entries: ``tiny.sweep`` and ``tiny.batch3``."""
    import json
    import shutil

    root = tmp_path_factory.mktemp("bench_root")
    here = os.path.join(ROOT, "port_bench")
    shutil.copytree(here, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads((root / "port_bench" / "configs" / "syn240.json").read_text())
    cfg.update(TINY, name="tiny")
    (root / "port_bench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "port_bench" / "traffic" / "batch16.json").read_text())
    traffic.update(batch=3)
    (root / "port_bench" / "traffic" / "batch3.json").write_text(json.dumps(traffic))
    limits = root / "port_bench" / "limits"
    shutil.copy(limits / "syn240.sweep.json", limits / "tiny.sweep.json")
    shutil.copy(limits / "syn240.batch16.json", limits / "tiny.batch3.json")
    bench["configs"].append({"name": "tiny", "source": "test", "file": "port_bench/configs/tiny.json",
                             "reduced": ["num_points"], "why": "test"})
    bench["workloads"] += [{"name": "tiny.sweep", "config": "tiny", "traffic": "sweep", "chips": 1, "why": "test"},
                           {"name": "tiny.batch3", "config": "tiny", "traffic": "batch3", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.sweep")
    bench["end_to_end"].append({"name": "batch_pairs_per_s", "unit": "pairs/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["tiny.batch3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def run_cpu(root, workload, seed, seconds, capsys):
    """One run of ``workload`` on the CPU; returns its result line."""
    import json

    import torch

    from port_bench import run

    torch.set_num_threads(2)
    assert run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                    device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
