"""Experiment sweep CLI of the torch port: synthetic conditions or Drunkard pairs on the card.

Counterpart of the repository's ``run_experiments.py``, with the same modes
and flags plus ``--device`` (default ``cuda``; ``cpu`` must be asked for).
It runs the model/triangulation/condition matrix through
``harness/sweep.run_sweep`` and writes the per-condition Experiment.txt
journals, the consolidated CSV (``--csv``) and the comparison against a
reference Experiments tree (``--compare``). Two defaults differ, because the
reference's data files are not part of this repository: without
``--config`` the synthetic mode uses the sweep condition's settings
(``harness/sweep_config.sweep_config``), and without ``--database`` every
fixture is generated from ``--seed``. The drunkard mode needs ``--config``
and ``--data-root``.

Example (the two conditions ``chip_smoke.py`` runs):
  python -m triangulation_in_deformable_scenes_torch.run_experiments \\
      --model ARAP_depth_3mm --triangulation InRays --depth 20 --shape Planar \\
      --types 2 5 --experiment 2 --out ./Experiments --csv ./errors.csv
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic", "drunkard"],
                    help="synthetic condition matrix or the Drunkard real-image sweep")
    ap.add_argument("--pair", nargs="+", default=None, help="drunkard: curated frame pairs (default: all four)")
    ap.add_argument("--level", nargs="+", default=None, help="drunkard: deformation levels (level0..level3)")
    ap.add_argument("--data-root", default=None, help="drunkard: dataset root with <res>/<scene>/<level>/ dirs")
    ap.add_argument("--model", nargs="+", default=["ARAP"], help="model families (see deformable.MODELS)")
    ap.add_argument("--triangulation", nargs="+", default=["InRays"], choices=["InRays", "TwoPoints", "FarPoints"])
    ap.add_argument("--depth", nargs="+", type=int, default=[20], choices=[20, 80, 150])
    ap.add_argument("--shape", nargs="+", default=["Planar"], choices=["Planar", "Gradual"])
    ap.add_argument("--types", nargs="+", type=int, default=None, help="experiment types 1-6")
    ap.add_argument("--experiment", nargs="+", type=int, default=[2], help="repetition index")
    ap.add_argument("--config", default=None,
                    help="reference-format YAML (synthetic default: the sweep condition's settings)")
    ap.add_argument("--database", default=None, help="fixture database root (default: generate fixtures)")
    ap.add_argument("--out", default="./Experiments")
    ap.add_argument("--csv", default=None, help="write consolidated CSV here")
    ap.add_argument("--compare", default=None,
                    help="write a cell-by-cell comparison CSV vs a reference Experiments tree here")
    ap.add_argument("--compare-root", default=None, help="root of the reference's Experiments tree")
    ap.add_argument("--rounds", type=int, default=5, help="outer optimization rounds")
    ap.add_argument("--nlopt-evals", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .config import load_config
    from .harness import sweep_config
    from .harness.aggregate import write_comparison_csv, write_condition_csv
    from .harness.sweep import SHAPE_EXPERIMENT_TYPES, SweepCondition, run_sweep

    if args.dataset == "drunkard":
        from .harness import real_sweep

        if not args.config:
            ap.error("--dataset drunkard requires --config (the dataset's reference-format YAML)")
        if not args.data_root:
            ap.error("--dataset drunkard requires --data-root")
        base = dataclasses.replace(
            load_config(args.config), n_optimizations=args.rounds, nlopt_n_optimizations=args.nlopt_evals
        )
        for pair in args.pair or real_sweep.PAIRS:
            real_sweep.run_real_sweep(
                base,
                args.data_root,
                pair,
                out_root=args.out,
                levels=args.level or real_sweep.LEVELS,
                experiments=args.experiment,
                on_result=lambda d, out: print(f"[{d}] {'ok' if out is not None else 'no pair triangulated'}"),
                device=args.device,
            )
        return

    base = load_config(args.config) if args.config else sweep_config.sweep_config()
    base = dataclasses.replace(base, n_optimizations=args.rounds, nlopt_n_optimizations=args.nlopt_evals)

    conditions = []
    for model in args.model:
        for tri in args.triangulation:
            for depth in args.depth:
                for shape in args.shape:
                    for etype in args.types or SHAPE_EXPERIMENT_TYPES[shape]:
                        for rep in args.experiment:
                            conditions.append(SweepCondition(model, tri, depth, shape, etype, rep))

    def progress(cond, res):
        print(
            f"[{cond.model}/{cond.triangulation}/{cond.depth_cm}cm/{cond.shape}"
            f"/type{cond.experiment_type}/{cond.experiment}] "
            f"err {res.initial.av_error*1000:.2f} -> {res.final.av_error*1000:.2f} mm"
        )

    run_sweep(
        base,
        conditions,
        out_root=args.out,
        database_root=args.database or None,
        seed=args.seed,
        progress=progress,
        device=args.device,
    )

    if args.csv:
        path = write_condition_csv(
            args.csv,
            args.out,
            models=args.model,
            triangulations=args.triangulation,
            shapes=args.shape,
            depth_cm=args.depth[0],
            experiment=args.experiment[0],
        )
        print(f"wrote {path}")

    if args.compare:
        if not args.compare_root:
            ap.error("--compare requires --compare-root")
        path, n_cells, n_wins = write_comparison_csv(
            args.compare,
            args.out,
            args.compare_root,
            models=args.model,
            triangulations=args.triangulation,
            shapes=args.shape,
            depth_cms=args.depth,
            experiment_types=args.types or [1, 2, 3, 4, 5, 6],
            experiments=args.experiment,
        )
        print(f"wrote {path}: {n_wins}/{n_cells} cells beat the reference finals")


if __name__ == "__main__":
    main()
