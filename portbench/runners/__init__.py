"""Runners of traffic mixes: a mix's file names its runner, a module here
with ``run(ctx) -> Outcome``."""
