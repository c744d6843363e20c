"""Shared command-line code of the port's image-sequence entry points.

Counterpart of ``triangulation_in_deformable_scenes_tpu/cli.py``: the
reference Execution mains' argument convention (``Execution/drunkard.cc:11-53``),
a positional ``dataset`` directory plus optional ``start step end`` frame
controls, with the dataset's reference-format YAML (``--config``, required:
the reference's ``Data/*.yaml`` files are not part of this repository) and
``--device`` (default ``cuda``; ``cpu`` must be asked for).

Reading frames needs OpenCV (``datasets/loaders.py``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import time

_TRAJECTORY_FILE = {
    "drunkard": "pose.txt",
    "realcolon": "trajectory.txt",
    "syncolon": "trajectory.txt",
}


def sequence_main(kind: str, argv=None):
    ap = argparse.ArgumentParser(description=f"{kind} two-view deformable mapping on the card")
    ap.add_argument("dataset", help="dataset directory")
    ap.add_argument("start", nargs="?", type=int, default=0)
    ap.add_argument("step", nargs="?", type=int, default=1)
    ap.add_argument("end", nargs="?", type=int, default=None)
    ap.add_argument("--config", required=True, help="reference-format YAML of the dataset")
    ap.add_argument("--trajectory", default=None, help="trajectory/pose file path")
    ap.add_argument("--journal", default=None)
    ap.add_argument("--mesh-backend", default="auto", choices=["auto", "native", "scipy"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .config import load_config
    from .datasets import DrunkardLoader, RealcolonLoader, SyncolonLoader
    from .datasets.loaders import _cv2
    from .pipeline.sequence import SequencePipeline

    cfg = load_config(args.config)

    traj = args.trajectory or os.path.join(args.dataset, _TRAJECTORY_FILE[kind])
    loader_cls = {
        "drunkard": DrunkardLoader,
        "realcolon": RealcolonLoader,
        "syncolon": SyncolonLoader,
    }[kind]
    loader = loader_cls(args.dataset, traj)
    print(f"[{kind}] {len(loader)} frames")

    border = None
    if cfg.border_mask:
        cv2 = _cv2()
        mask_path = cfg.border_mask
        if not os.path.isabs(mask_path):
            mask_path = os.path.join(os.path.dirname(args.config), mask_path)
        border = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)

    pipe = SequencePipeline(cfg, border_mask=border, device=args.device)
    t0 = time.time()
    out = pipe.run(
        loader,
        start=args.start,
        end=args.end,
        step=args.step,
        journal_path=args.journal,
        mesh_backend=args.mesh_backend,
    )
    dt = time.time() - t0
    if out is None:
        print("No pair triangulated.")
    else:
        init = out["init"]
        print(
            f"nMatches: {init.n_matches}  nMapPoints: {init.n_triangulated}"
            f"  parallax: {init.parallax_deg:.3f} deg"
        )
        print(
            f"RMSE (mm): {out['initial'].rmse*1000:.2f} -> {out['final'].rmse*1000:.2f}"
            f"   pixel sigma C1/C2: {out['initial_pix'].desvc1:.3f}/{out['initial_pix'].desvc2:.3f}"
            f" -> {out['final_pix'].desvc1:.3f}/{out['final_pix'].desvc2:.3f}"
        )
    print(f"[END] Seconds: {dt:.4f}")
