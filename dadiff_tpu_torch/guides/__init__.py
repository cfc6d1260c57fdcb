"""Sampling engine and planning policies."""
