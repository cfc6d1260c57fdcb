"""Utilities of the port: training (``training``), experiment configs
(``config``), profiling on torch.profiler (``profiling``), finite checks
(``debug``) and array helpers (``arrays``)."""
