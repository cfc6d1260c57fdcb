"""Environments and evaluation: the batched PointMaze on the device, the
on-device plan-step-replan loop, and the host (gymnasium) evaluators."""
