"""Denoiser families, one module each, found by a configuration's
``family`` (``spec.family``): the port's denoiser, the planner path it
takes and the work of one call, counted from shapes. The plain forward of
each family is ``reference/<family>.py``.

``PLANNER = "k2"`` has to agree with the port: ``make_bo_sampler``
(``dadiff_tpu_torch/ops/planner.py``) takes K2 only for a
``TemporalUnet``, so a new K2 family also needs that check widened in the
port."""
