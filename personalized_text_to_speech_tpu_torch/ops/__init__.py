"""Tensor ops of the port: masking, splines, and MAS with its Hopper kernel."""
