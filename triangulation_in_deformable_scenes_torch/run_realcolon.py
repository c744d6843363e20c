"""RealColon endoscopy CLI of the torch port (equivalent of ``Execution/realcolon.cc``).

Iterates frames from ``start`` to ``end`` with ``step``, stops at the first
pair that triangulates, refines it on the card and writes the
Experiment.txt journal.

Usage:
  python -m triangulation_in_deformable_scenes_torch.run_realcolon DATASET_DIR [start step end]
      --config PATH [--trajectory PATH] [--journal PATH]
      [--mesh-backend auto|native|scipy] [--device cuda|cpu]
"""

from .cli import sequence_main

if __name__ == "__main__":
    sequence_main("realcolon")
