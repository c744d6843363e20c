"""Syncolon synthetic-colon CLI of the torch port (equivalent of ``Execution/syncolon.cc``).

Iterates frames from ``start`` to ``end`` with ``step``, stops at the first
pair that triangulates, refines it on the card and writes the
Experiment.txt journal.

Usage:
  python -m triangulation_in_deformable_scenes_torch.run_syncolon DATASET_DIR [start step end]
      --config PATH [--trajectory PATH] [--journal PATH]
      [--mesh-backend auto|native|scipy] [--device cuda|cpu]
"""

from .cli import sequence_main

if __name__ == "__main__":
    sequence_main("syncolon")
