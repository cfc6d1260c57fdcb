"""Checkpoint input and output."""
