"""Distill a trained planner into a consistency student: the counterpart of
the JAX package's scripts/distill.py.

    python -m dadiff_tpu_torch.distill --checkpoint teacher.pt \
        --dataset npz:data/pointmaze_umaze_expert.npz --n-epochs 150 \
        --batch-size 256 --lr 1e-4 --log-dir logs

Runs on the card; ``--device cpu`` runs the plain versions. The student's
``checkpoint_step_N.pt`` plans with ``--sampler consistency`` in
``python -m dadiff_tpu_torch.evaluate``, ``.eval_ondevice`` and ``.serve``.
"""

import sys

from dadiff_tpu_torch.cli import distill_main

if __name__ == "__main__":
    distill_main(sys.argv[1:])
