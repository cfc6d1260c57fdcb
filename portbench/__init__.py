"""The benchmark of the PyTorch/CUDA port (``dadiff_tpu_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python3 portbench/run.py --workload unet_umaze.serve_closed8 \
        --seed 1234 --seconds 30 --trace 0

A cell names a configuration (``configs/<name>.json``, whose ``family``
names ``families/<family>.py`` and ``reference/<family>.py``) and a traffic
mix (``traffic/<name>.json``, whose ``runner`` is a module of
``runners/``); each per-layer metric is read by ``metrics/<name before the
first dot>.py``. ``reference/`` is the plain PyTorch and NumPy reference
that decides ``correct``; it imports nothing of the port. Importing this
package imports no torch.
"""
