"""Kernels (csrc/*.cu) and the tensor functions around them."""
