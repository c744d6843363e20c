"""Aggregation of experiment journals into regression CSV tables.

Parity with ``Data/Scripts/synthetic/{convert_to_csv, automated_loop_to_csv,
create_exp_resume}.py``: consolidates per-condition ``Experiment.txt`` files
into the committed Excel/CSV shape (``Data/Excels/Synthetic/**``): one row per
movement condition, columns ``<Model>-<Triangulation> Initial (mm)`` /
``Final (mm)``, values in es_ES decimal-comma format so the tables diff
cleanly against the reference's.

The port's copy of ``triangulation_in_deformable_scenes_tpu/harness/aggregate.py``,
over the port's own ``utils/journal.parse_journal``.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable

from ..utils.journal import parse_journal
from .sweep import EXPERIMENT_TYPES, SweepCondition, movement_dirname


def journal_to_row(path: str) -> dict:
    """Extract Initial/Final absolute errors (mm) and movement from a journal."""
    blocks = parse_journal(path)
    initial = blocks.get("INITIAL", {})
    final = blocks.get("FINAL", {})
    return {
        "movement": initial.get("Av. movement", 0.0),
        "initial": initial.get("Av. error", 0.0),
        "final": final.get("Av. error", 0.0),
        "initial_rmse": initial.get("RMSE", 0.0),
        "final_rmse": final.get("RMSE", 0.0),
    }


def _fmt(x: float) -> str:
    return f"{x:.2f}".replace(".", ",")


def write_condition_csv(
    out_path: str,
    experiments_root: str,
    models: Iterable[str],
    triangulations: Iterable[str],
    shapes=("Planar", "Gradual"),
    depth_cm: int = 20,
    experiment: int = 2,
):
    """Build the per-condition comparison table (committed Errors N.csv shape)."""
    models = list(models)
    triangulations = list(triangulations)

    header = ["Avg Movement", "Shape", "Gaussian Mov", "Rigid Mov"]
    for m in models:
        for t in triangulations:
            header += [f"{m}-{t} Initial (mm)", f"{m}-{t} Final (mm)"]

    rows = []
    for shape in shapes:
        for etype, p in EXPERIMENT_TYPES.items():
            if shape == "Gradual" and etype in (1, 4):
                continue  # shape_syn_experiment_types: Gradual skips pure-gaussian
            row_cells = [None, shape, _fmt(p["gaussian"]), _fmt(p["rigid"])]
            movement = None
            any_found = False
            for m in models:
                for t in triangulations:
                    cond = SweepCondition(m, t, depth_cm, shape, etype, experiment)
                    jp = os.path.join(experiments_root, cond.result_dir, "Experiment.txt")
                    if os.path.exists(jp):
                        r = journal_to_row(jp)
                        movement = movement if movement is not None else r["movement"]
                        row_cells += [_fmt(r["initial"]), _fmt(r["final"])]
                        any_found = True
                    else:
                        row_cells += ["", ""]
            if not any_found:
                continue
            row_cells[0] = _fmt(movement or 0.0)
            rows.append(row_cells)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return out_path


def write_comparison_csv(
    out_path: str,
    ours_root: str,
    ref_root: str,
    models: Iterable[str],
    triangulations: Iterable[str],
    shapes=("Planar", "Gradual"),
    depth_cms=(20,),
    experiment_types=(2, 5, 6),
    experiments=(1, 2, 3),
):
    """Cell-by-cell accuracy comparison against the reference's COMMITTED
    per-condition traces (``Data/Experiments/<Model>/<Tri>/...``).

    One row per (model, tri, depth, shape, type, repetition) where BOTH
    sides have a journal; columns hold each side's Initial/Final avg error
    (mm, '.' decimals -- this table is for analysis, not byte-diffing) and a
    ``win`` flag (our final strictly smaller). Returns (path, n_cells,
    n_wins). Cells whose reference journal is missing are skipped -- the
    reference's sweep coverage is partial (e.g. ARAP_depth_* exists only at
    20cm depth).
    """
    rows = []
    n_win = 0
    for m in models:
        for t in triangulations:
            for depth_cm in depth_cms:
                for shape in shapes:
                    for etype in experiment_types:
                        if shape == "Gradual" and etype in (1, 4):
                            continue
                        for rep in experiments:
                            cond = SweepCondition(m, t, depth_cm, shape, etype, rep)
                            ours = os.path.join(ours_root, cond.result_dir, "Experiment.txt")
                            ref = os.path.join(ref_root, cond.result_dir, "Experiment.txt")
                            if not (os.path.exists(ours) and os.path.exists(ref)):
                                continue
                            ro = journal_to_row(ours)
                            rr = journal_to_row(ref)
                            win = ro["final"] < rr["final"]
                            n_win += int(win)
                            p = EXPERIMENT_TYPES[etype]
                            rows.append([
                                m, t, depth_cm, shape, p["gaussian"], p["rigid"], rep,
                                f"{ro['initial']:.3f}", f"{ro['final']:.3f}",
                                f"{rr['initial']:.3f}", f"{rr['final']:.3f}",
                                int(win),
                            ])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([
            "Model", "Triangulation", "Depth (cm)", "Shape", "Gaussian Mov",
            "Rigid Mov", "Experiment", "Ours Initial (mm)", "Ours Final (mm)",
            "Ref Initial (mm)", "Ref Final (mm)", "Win",
        ])
        w.writerows(rows)
    return out_path, len(rows), n_win
