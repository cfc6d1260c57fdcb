"""Evaluate a diffusion planner on a gymnasium env: the counterpart of the
JAX package's scripts/evaluate.py.

    python -m dadiff_tpu_torch.evaluate --checkpoint logs/.../checkpoint_step_N.pt \
        --dataset npz:data/pointmaze_umaze_expert.npz --env PointMaze_UMaze-v3 \
        --policy-type dynamics-aware --n-candidates 8 --megakernel \
        --n-episodes 100 --seed 1000 --batched

Plans on the card; ``--device cpu`` runs the plain versions. Writes the
timestamped results JSON under ``--results-dir``.
"""

import sys

from dadiff_tpu_torch.cli import evaluate_main

if __name__ == "__main__":
    evaluate_main(sys.argv[1:])
