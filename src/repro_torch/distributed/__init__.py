"""Distributed helpers of the port (only gradient compression so far)."""
