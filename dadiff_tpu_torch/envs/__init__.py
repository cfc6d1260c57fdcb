"""Environments and evaluation: the batched PointMaze on the device, the
on-device plan-step-replan loop, the host (gymnasium) evaluators, and the
waypoint and MPPI experts that collect training data on the host."""
