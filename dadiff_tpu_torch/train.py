"""Train a diffusion planner: the counterpart of the JAX package's
scripts/train.py.

    python -m dadiff_tpu_torch.train --dataset npz:data/pointmaze_umaze_expert.npz \
        --horizon 32 --dim 128 --dim-mults 1 2 4 --n-timesteps 100 \
        --batch-size 32 --log-dir logs

Runs on the card; ``--device cpu`` runs the plain versions. The log directory
gets ``checkpoint_step_N.pt`` in the reference schema, which
``python -m dadiff_tpu_torch.serve`` and ``dadiff_tpu_torch.probe_megakernel``
read.
"""

import sys

from dadiff_tpu_torch.cli import train_main

if __name__ == "__main__":
    train_main(sys.argv[1:])
