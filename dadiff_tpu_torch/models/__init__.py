"""Denoiser and diffusion modules."""
