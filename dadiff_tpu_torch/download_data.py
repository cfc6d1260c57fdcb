"""Dataset management: the counterpart of the JAX package's
scripts/download_data.py (logic in ``cli.download_main``).

    python -m dadiff_tpu_torch.download_data --collect synthetic:pointmaze \\
        --episodes 200 --out data/pointmaze.npz
    python -m dadiff_tpu_torch.download_data --collect \\
        expert:PointMaze_UMaze-v3 --episodes 50 --out umaze.npz
    python -m dadiff_tpu_torch.download_data --info synthetic:pointmaze

Host-side numpy: ``synthetic:`` and ``npz:`` run anywhere; ``gym:``,
``expert:`` and ``mppi:`` need gymnasium (and mujoco), so they run where
those are installed, not on the card's machine; ``--list`` and minari
names need minari.
"""

import sys

from dadiff_tpu_torch.cli import download_main

if __name__ == "__main__":
    download_main(sys.argv[1:])
