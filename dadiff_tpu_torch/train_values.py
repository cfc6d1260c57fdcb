"""Train a trajectory value net: the counterpart of the JAX package's
scripts/train_values.py.

    python -m dadiff_tpu_torch.train_values \
        --dataset npz:data/pointmaze_umaze_expert.npz --horizon 32 \
        --n-timesteps 100 --reward goal-dense --log-dir logs/values

Runs on the card; ``--device cpu`` runs it on the CPU. The log directory
gets ``value_final.pt``, which ``--policy-type value-guided
--value-checkpoint`` (or ``dynamics-aware`` with ``--value-checkpoint``)
reads in ``python -m dadiff_tpu_torch.evaluate`` and ``.serve``; the
planner must use the schedule the net was trained on.
"""

import sys

from dadiff_tpu_torch.cli import train_value_main

if __name__ == "__main__":
    train_value_main(sys.argv[1:])
