"""Streaming journal subsystem — telemetry appended into scda archives.

    from repro_torch.journal import ScdaJournal, read_records

    j = ScdaJournal("run/step_0000000500.scda")
    j.log(step, {"loss": 1.25, "lr": 3e-4})
    ...
    j.flush()                       # one framed varray section per flush

    for rec in read_records("run/step_0000000500.scda"):
        print(rec["step"], rec["data"])

Built entirely on mode-'a' appends (:func:`repro.core.fopen_append`), so
a journaled archive remains byte-identical to one a single serial session
would have written, and every format tool (``scdatool ls/fsck/verify/
tail``) understands it.
"""
from repro_torch.journal.journal import (JOURNAL_USER_STRING, RECORD_VERSION,
                                   DEFAULT_FLUSH_RECORDS, ScdaJournal,
                                   decode_record, encode_record,
                                   flatten_scalars, iter_records,
                                   journal_flush_records, read_records)

__all__ = [
    "JOURNAL_USER_STRING", "RECORD_VERSION", "DEFAULT_FLUSH_RECORDS",
    "ScdaJournal", "decode_record", "encode_record", "flatten_scalars",
    "iter_records", "journal_flush_records", "read_records",
]
