"""Data pipeline of the port: audio IO, filelist dataset, bucketed batching."""
