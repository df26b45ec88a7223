"""Bytes and roofline models of the port (see analysis.py)."""
