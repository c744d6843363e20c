"""Real-image (Drunkard's Dataset) experiment sweep with per-pair presets.

Parity with ``Data/Scripts/drunkard/run_real_experiments.py`` +
``Data/Scripts/config.py``: the four curated frame pairs with their
matching/parallax/depth presets (``config.py:24-40``), per-resolution camera
intrinsics (``run_real_experiments.py:80-87``), the Triangulation x Level x
Checks matrix with level0 being the only level that also runs "checks"
(``config.py:17-22``), and the committed result layout
``<out>/Drunkard/<pair>/<triangulation>/<level>/<checks>/<n>/Experiment.txt``
-- executed in-process against ``SequencePipeline`` instead of re-running a
compiled binary with a rewritten YAML.

The port's copy of ``triangulation_in_deformable_scenes_tpu/harness/real_sweep.py``;
``run_real_sweep`` takes a ``device`` (default ``cuda``) for the pipeline.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Optional

from ..config import Config
from ..datasets import DrunkardLoader
from ..pipeline.sequence import SequencePipeline

# The four curated pairs (Data/Scripts/config.py:3-9).
PAIRS = (
    "320_00000_1975-1983",
    "320_00000_2500-2513",
    "1024_00000_1229-1236",
    "1024_00001_110-120",
)

TRIANGULATIONS = ("InRays", "TwoPoints", "FarPoints")
LEVELS = ("level0", "level1", "level2", "level3")

# Per-level checks matrix (config.py:17-22).
LEVEL_CHECKS = {
    "level0": ("checks", "no_checks"),
    "level1": ("no_checks",),
    "level2": ("no_checks",),
    "level3": ("no_checks",),
}

# Per-pair presets (config.py:24-40): Hamming distance, search window,
# depth limit (m), min parallax (deg).
PAIR_PRESETS = {
    "1024_00000_1229-1236": {"Hdist": 30, "window": 75, "maxDepth": 2.5, "minParallax": 1.9},
    "1024_00001_110-120": {"Hdist": 30, "window": 120, "maxDepth": 6.0, "minParallax": 0.6},
    "320_00000_2500-2513": {"Hdist": 35, "window": 40, "maxDepth": 3.5, "minParallax": 1.6},
    "320_00000_1975-1983": {"Hdist": 35, "window": 40, "maxDepth": 3.5, "minParallax": 0.6},
}

# Per-resolution intrinsics (run_real_experiments.py:80-87).
CAMERA_INTRINSICS = {
    "320": {"fx": 190.68059285, "fy": 190.68059285, "cx": 160.0, "cy": 160.0,
            "cols": 320, "rows": 320},
    "1024": {"fx": 610.17789714, "fy": 610.17789714, "cx": 512.0, "cy": 512.0,
             "cols": 1024, "rows": 1024},
}

# The reference maps triangulation axis values straight into
# Triangulation.seed.location; "InRays" spells differently in the yaml.
SEED_LOCATION = {"InRays": "inRays", "TwoPoints": "TwoPoints", "FarPoints": "FarPoints"}


def parse_pair(pair: str):
    """'320_00000_1975-1983' -> (resolution, scene, start, end, step)."""
    resolution, scene, frames = pair.split("_")
    start_s, end_s = frames.split("-")
    start, end = int(start_s), int(end_s)
    return resolution, scene, start, end, end - start


def pair_config(base: Config, pair: str, triangulation: str, checks: str) -> Config:
    """Apply the pair preset + intrinsics + sweep axes to the base config
    (the keys run_real_experiments.py:92-128 rewrites in Drunkard.yaml)."""
    resolution, _, _, _, _ = parse_pair(pair)
    intr = CAMERA_INTRINSICS[resolution]
    preset = PAIR_PRESETS[pair]
    return dataclasses.replace(
        base,
        fx=intr["fx"],
        fy=intr["fy"],
        cx=intr["cx"],
        cy=intr["cy"],
        im_cols=intr["cols"],
        im_rows=intr["rows"],
        matching_init_th=preset["Hdist"],
        matching_init_radius=preset["window"],
        depth_limit=preset["maxDepth"],
        min_cos=preset["minParallax"],
        checks=(checks == "checks"),
        triangulation_location=SEED_LOCATION[triangulation],
    )


def run_real_sweep(
    base_cfg: Config,
    dataset_root: str,
    pair: str,
    out_root: str = "./Experiments",
    triangulations: Iterable[str] = TRIANGULATIONS,
    levels: Iterable[str] = LEVELS,
    checks: Optional[Iterable[str]] = None,
    experiments: Iterable[int] = (1,),
    on_result: Optional[Callable] = None,
    frame_range: Optional[tuple] = None,
    device="cuda",
):
    """Run the Triangulation x Level x Checks x Experiment matrix for one pair.

    ``dataset_root`` is the Drunkard dataset root containing
    ``<resolution>/<scene>/<level>/`` sequence directories
    (run_real_experiments.py:130). ``frame_range`` = (start, end, step)
    overrides the indices parsed from the pair name (testing with truncated
    sequences). Returns a list of (result_dir, pipeline_output | None).
    """
    resolution, scene, start, end, step = parse_pair(pair)
    if frame_range is not None:
        start, end, step = frame_range
    results = []
    for triangulation in triangulations:
        for level in levels:
            level_checks = checks if checks is not None else LEVEL_CHECKS[level]
            for check in level_checks:
                for n in experiments:
                    seq_dir = os.path.join(dataset_root, resolution, scene, level)
                    result_dir = os.path.join(
                        out_root, "Drunkard", pair, triangulation, level, check, str(n)
                    )
                    os.makedirs(result_dir, exist_ok=True)
                    cfg = pair_config(base_cfg, pair, triangulation, check)
                    loader = DrunkardLoader(seq_dir, os.path.join(seq_dir, "pose.txt"))
                    pipe = SequencePipeline(cfg, device=device)
                    out = pipe.run(
                        loader,
                        start=start,
                        end=end + 1,
                        step=step,
                        journal_path=os.path.join(result_dir, "Experiment.txt"),
                    )
                    results.append((result_dir, out))
                    if on_result is not None:
                        on_result(result_dir, out)
    return results
