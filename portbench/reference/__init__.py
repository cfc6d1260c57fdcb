"""The plain reference that decides ``correct``: NumPy and plain PyTorch
operations, written from the published layer equations and the data file.
It imports neither JAX nor anything of ``dadiff_tpu`` or
``dadiff_tpu_torch``; it takes the weights and the observations that the
benchmark made and hands to both sides, never what the port derived from
them.
"""
