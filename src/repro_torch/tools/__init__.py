"""Archive tooling for scda files.

``scdatool`` (console entry point; also ``python -m repro.tools.cli``) is
the archivist's Swiss-army knife over the format: ``ls`` (section table),
``cat`` (payload extraction), ``fsck`` (structural validation), ``index``
(``.scdax`` sidecar management), and ``copy`` (rewrite, optionally
re/de-compressing every payload).
"""
from repro_torch.tools.fsck import Finding, fsck_file

__all__ = ["Finding", "fsck_file"]
