"""Model configurations of the port (counterpart of `repro.configs`; only
the paper's own SimGNN-AIDS model is ported in this slice)."""
