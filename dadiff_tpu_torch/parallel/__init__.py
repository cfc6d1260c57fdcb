"""Parallelism layer on ``torch.distributed``: process groups, device
meshes, data-parallel and FSDP training, mesh-sharded planners and
evaluators, tensor and sequence parallelism, and collective counts.

Counterpart of the JAX package's parallel/ (mesh.py, planner.py, tp.py,
distributed.py, comm_analysis.py). JAX runs one program over a mesh and XLA
inserts the collectives; here one process runs per device (torchrun), and
every rank computes its block of the global batch, or its shard of the
model, with the collectives written out. A single process with no mesh runs
the path it ran before.
"""
