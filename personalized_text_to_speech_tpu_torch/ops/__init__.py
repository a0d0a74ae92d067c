"""Tensor ops of the port: masking, splines, spectrograms, and MAS with its
Hopper kernel."""
