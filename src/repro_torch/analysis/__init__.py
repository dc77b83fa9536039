"""Per-cell counts of a traced step (the port of ``repro.analysis``)."""
