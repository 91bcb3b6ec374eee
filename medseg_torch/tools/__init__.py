"""Measurement scripts for the port, run as ``python -m medseg_torch.tools.<name>``."""
