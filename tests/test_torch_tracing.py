"""The port's tracing (``triangulation_in_deformable_scenes_torch/tracing.py``):
spans, host reads and kernel timers, off by default.

On the CPU: tracing off records nothing and changes no result; on, the span
counts equal the LM loop's own counters, spans nest as the layers do, a read
counts once, self times are never negative, a span that ends after
``collect()`` is ignored, and the recorded clock offset lays the spans on a
``torch.profiler`` trace. On the card (``cuda`` marker): every host sync of a
240-point inner solve goes through ``tracing.read`` (the sync-debug warnings
equal the read count), and kernel 1's event timers agree with the profiler's
device time. Run those there, where JAX is not installed, without the
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda
"""

import os
import time
import warnings

import numpy as np
import pytest
import torch

from test_torch_problems import deforming_problem, rigid_problem, run_pipeline, torch_problem
from triangulation_in_deformable_scenes_torch import tracing
from triangulation_in_deformable_scenes_torch.models import deformable, outer, rigid

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    tracing.collect()
    yield
    tracing.collect()


def _on(fn):
    """(fn(), the recording of that call)."""
    tracing.enable()
    try:
        out = fn()
    finally:
        rec = tracing.collect()
    return out, rec


def _solve(backend, monkeypatch, n_iterations=8):
    """A 25-point deforming pair through ``solve_pair`` on the CPU; the block
    backend by lowering the dense limit below the pair's tangent dim."""
    if backend == "block":
        monkeypatch.setattr(deformable, "DENSE_DIM_LIMIT", 8)
    data, state, hyper = torch_problem(deforming_problem())
    return lambda: deformable.solve_pair("KB8", data, hyper, state, n_iterations)


def _ancestors(raw, i):
    names = []
    p = raw[i][3]
    while p >= 0:
        names.append(raw[p][0])
        p = raw[p][3]
    return names


def _rigid_solves(rec):
    raw = rec["raw"]
    return sum(1 for i, s in enumerate(raw) if s[0] == "lm.solve" and "rigid.select" in _ancestors(raw, i))


def test_off_records_nothing():
    assert tracing._rec is None
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    assert tracing.kernel("kernel1", "cpu") is a
    with a:
        assert tracing.read(torch.tensor(True), bool) is True
    data, state, hyper = torch_problem(deforming_problem(n_side=4))
    deformable.solve_pair("KB8", data, hyper, state, 2)
    assert tracing._rec is None
    assert tracing.collect() == {}


@pytest.mark.parametrize("backend", ["dense", "block"])
def test_solve_pair_bits_do_not_move(backend, monkeypatch):
    solve = _solve(backend, monkeypatch)
    off = solve()
    on, rec = _on(solve)
    assert rec["spans"]["lm.solve"]["calls"] == 1
    assert off.n_solves == on.n_solves and off.n_accepted == on.n_accepted
    for a, b in zip(off.state, on.state):
        assert torch.equal(a, b)
    assert torch.equal(off.cost, on.cost)


@pytest.mark.parametrize("backend", ["dense", "block"])
def test_spans_count_what_the_lm_loop_counts(backend, monkeypatch):
    res, rec = _on(_solve(backend, monkeypatch))
    spans = rec["spans"]
    assert spans["lm.trial"]["calls"] == res.n_solves > res.n_accepted > 0
    assert spans["cost"]["calls"] == res.n_solves + 1
    assert res.n_accepted <= spans["assembly"]["calls"] <= res.n_accepted + 1
    assert all(s["self_s"] >= 0.0 and s["total_s"] >= s["self_s"] for s in spans.values())
    # The dense trial reads its accept decision once; the CPU's block PCG
    # also reads its stop test once an iteration.
    if backend == "dense":
        assert spans["lm.solve"]["reads"] == spans["lm.trial"]["reads"] == res.n_solves == rec["reads"]
    else:
        assert spans["lm.solve"]["reads"] == rec["reads"] > res.n_solves
    assert rec["kernels"] == {"kernel1": {"launches": 0, "device_s": 0.0}, "kernel2": {"launches": 0, "device_s": 0.0}}


def test_rigid_selection_counts():
    data, state, hyper = torch_problem(rigid_problem(n_side=5))
    stats = outer.SolveStats()
    _, rec = _on(lambda: rigid.solve_rigid("KB8", data, hyper, state, 6, max_restarts=2, stats=stats))
    spans = rec["spans"]
    assert spans["rigid.select"]["calls"] == 1
    assert spans["lm.solve"]["calls"] == stats.inner_solves
    assert spans["lm.trial"]["calls"] == stats.lm_solves == stats.rigid_solves
    assert spans["cost"]["calls"] == stats.lm_solves + stats.inner_solves
    assert stats.lm_iterations <= spans["assembly"]["calls"] <= stats.lm_iterations + stats.inner_solves
    # One accept read a trial, one comparison of the two starts a round, one
    # score a round.
    assert spans["rigid.select"]["reads"] == stats.lm_solves + stats.inner_solves


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """One CPU condition at a one-round budget with tracing on, and the same
    condition with tracing off."""
    tmp = str(tmp_path_factory.mktemp("tracing"))
    tracing.collect()
    off, _ = run_pipeline("torch", 40, 0, 1, 3, 5, tmp, device="cpu")
    tracing.enable()
    try:
        on, _ = run_pipeline("torch", 40, 0, 1, 3, 5, tmp, device="cpu")
    finally:
        rec = tracing.collect()
    return off, on, rec


def test_pipeline_result_unchanged(pipeline):
    off, on, _ = pipeline
    for a, b in zip(off.state, on.state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(off.weights, on.weights)
    assert off.rounds == on.rounds and off.stats == on.stats


def test_pipeline_spans_nest(pipeline):
    _, on, rec = pipeline
    raw, spans = rec["raw"], rec["spans"]
    total = {name: s["total_s"] for name, s in spans.items()}
    assert spans["pipeline.condition"]["calls"] == spans["outer.search"]["calls"] == 1
    assert total["lm.solve"] <= total["outer.search"] <= total["pipeline.condition"]
    for i, (name, t0, t1, parent, cond) in enumerate(raw):
        assert cond == 0 and t0 <= t1
        if name == "lm.solve":
            assert "outer.search" in _ancestors(raw, i)
        if parent >= 0:
            assert raw[parent][1] <= t0 and t1 <= raw[parent][2]
        else:
            assert name == "pipeline.condition"
    assert all(s["self_s"] >= 0.0 for s in spans.values())
    self_sum = sum(s["self_s"] for s in spans.values())
    assert self_sum == pytest.approx(total["pipeline.condition"], rel=1e-9)


def test_pipeline_counts(pipeline):
    _, on, rec = pipeline
    spans, stats = rec["spans"], on.stats
    assert spans["outer.round"]["calls"] == spans["outer.mesh"]["calls"] == on.rounds == 1
    assert spans["rigid.select"]["calls"] == 1
    assert spans["lm.solve"]["calls"] == stats.inner_solves
    assert spans["lm.trial"]["calls"] == stats.lm_solves
    assert spans["cost"]["calls"] == stats.lm_solves + stats.inner_solves
    # Every deformable inner solve is one search evaluation.
    assert spans["outer.eval"]["calls"] == stats.inner_solves - _rigid_solves(rec) > 0
    assert rec["reads"] == spans["pipeline.condition"]["reads"] == spans["sync"]["calls"]
    assert spans["lm.solve"]["reads"] == stats.lm_solves


def test_conditions_are_numbered():
    tracing.enable()
    with tracing.span("free"):
        pass
    for _ in range(2):
        with tracing.span(tracing.CONDITION):
            with tracing.span("inner"):
                pass
    rec = tracing.collect()
    assert [(s[0], s[4]) for s in rec["raw"]] == [
        ("free", None), ("pipeline.condition", 0), ("inner", 0), ("pipeline.condition", 1), ("inner", 1)]


@pytest.mark.parametrize("conv", [bool, float, int, None, torch.Tensor.cpu])
def test_read_counts_one_per_call(conv):
    t = torch.tensor([2.0]) if conv is not None else torch.arange(3.0)
    want = t.cpu().numpy() if conv is None else conv(t)
    tracing.enable()
    with tracing.span("outer"):
        got = tracing.read(t, conv)
        tracing.read(t, conv)
    tracing.read(t, conv)
    rec = tracing.collect()
    assert type(got) is type(want)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert rec["reads"] == rec["spans"]["sync"]["calls"] == 3
    assert rec["spans"]["outer"]["reads"] == 2
    assert [s[3] for s in rec["raw"] if s[0] == "sync"] == [0, 0, -1]


def test_self_time_excludes_children():
    tracing.enable()
    with tracing.span("parent"):
        time.sleep(0.002)
        for _ in range(2):
            with tracing.span("child"):
                time.sleep(0.003)
    rec = tracing.collect()
    p, c = rec["spans"]["parent"], rec["spans"]["child"]
    assert c["calls"] == 2 and c["self_s"] == c["total_s"] >= 0.006
    assert p["self_s"] == pytest.approx(p["total_s"] - c["total_s"], abs=1e-9)
    assert p["self_s"] >= 0.002


def test_exit_after_collect_is_a_noop():
    class Closed(Exception):
        pass

    tracing.enable()
    with pytest.raises(Closed):
        with tracing.span("open"):
            with tracing.span("inner"):
                rec = tracing.collect()
                raise Closed
    assert tracing._rec is None
    assert rec["spans"]["open"]["calls"] == rec["spans"]["inner"]["calls"] == 1
    # Closed at the collect instant, not when the exception unwound them.
    assert rec["raw"][0][2] == rec["raw"][1][2]
    assert tracing.collect() == {}
    # A new recording ignores the spans of the old one ending.
    tracing.enable()
    s = tracing.span("old")
    s.__enter__()
    tracing.enable()
    s.__exit__(None, None, None)
    assert tracing.collect()["spans"] == {}


def test_spans_lie_on_the_profiler_clock(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    solve = _solve("dense", monkeypatch, n_iterations=3)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        res = solve()
    rec = tracing.collect()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "span.lm.trial")
    ours = [(t0, t1) for name, t0, t1, _, _ in rec["raw"] if name == "lm.trial"]
    assert len(ranges) == len(ours) == res.n_solves
    off = rec["clock"]["profiler_offset_ns"]
    for (a, _), (t0, _) in zip(ranges, ours):
        assert abs(a - (t0 + off)) < 1_000_000


def _sweep_inner_solve(tmp, monkeypatch):
    """The arguments of the first inner solve of the 240-point sweep condition
    on the card (the search's first evaluation)."""
    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    class Got(Exception):
        pass

    seen = []

    def grab(*args):
        seen.append(args)
        raise Got

    cfg = sc.sweep_config(n_optimizations=1, nlopt_evals=1, n_opt_iterations=25)
    of, mf = sc.write_fixture(os.path.join(tmp, "fixture"), num_points=240, seed=0)
    pipe = SimulationPipeline(cfg, seed=0, mesh_backend=sc.MESH_BACKEND, device="cuda")
    with monkeypatch.context() as m:
        m.setattr(deformable, "solve_pair", grab)
        with pytest.raises(Got):
            pipe.run(of, mf, journal_path=os.path.join(tmp, "journal.txt"))
    return seen[0]


@pytest.mark.cuda
def test_card_syncs_are_the_reads_and_kernel_timers_match_the_profiler(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    args = _sweep_inner_solve(str(tmp_path), monkeypatch)
    assert args[1].kp1.shape[0] == 240
    deformable.solve_pair(*args)  # warm-up
    torch.cuda.synchronize()

    tracing.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = deformable.solve_pair(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        rec = tracing.collect()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert rec["reads"] == len(syncs) == res.n_solves, [f"{w.filename}:{w.lineno}" for w in syncs]
    assert rec["kernels"]["kernel1"]["launches"] == res.n_solves

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = deformable.solve_pair(*args)
        torch.cuda.synchronize()
    rec = tracing.collect()
    device = [e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
              if "damped_solve_kernel" in e.name() and e.device_type() == torch.autograd.DeviceType.CUDA]
    timed = rec["kernels"]["kernel1"]
    print(f"kernel 1: {timed['launches']} launches, events {timed['device_s'] * 1e3:.4f} ms, "
          f"profiler {sum(device) / 1e6:.4f} ms over {len(device)} records")
    assert timed["launches"] == res.n_solves == len(device)
    assert abs(timed["device_s"] * 1e9 - sum(device)) <= 0.1 * sum(device)
