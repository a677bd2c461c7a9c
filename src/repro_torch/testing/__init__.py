"""Test harnesses of the port (fault injection)."""
