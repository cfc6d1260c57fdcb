"""PyTorch and CUDA port of this repository's JAX package: dynamics-aware
diffusion planning on an NVIDIA H100.

The JAX package is the reference; this package imports nothing of it and
nothing of JAX. Each module names its counterpart there by file and line,
relative to the JAX package's directory (``ops/pallas_planner.py:95``).
Entry points run on the card unless the caller passes ``device="cpu"`` (or
``--device cpu``), where every kernel wrapper takes its plain PyTorch
version.
"""
