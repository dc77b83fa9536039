"""scda — the paper's primary contribution: a minimal, serial-equivalent
format for parallel I/O (Griesbach & Burstedde, 2023).

Public API (mirrors the paper's Appendix A, pythonically):

    from repro_torch.core import fopen_write, fopen_read, SerialComm, ThreadComm

    with fopen_write(comm, path, user_string=b"ckpt") as f:
        f.write_inline(b"step", step_bytes32)
        f.write_block(b"manifest", manifest_json, encode=True)
        f.write_array(b"weights", local_bytes, counts, elem_size)

    with fopen_read(comm, path) as r:
        hdr = r.read_section_header(decode=True)
        data = r.read_array_data(my_new_partition, hdr.E)

The format layer (spec/encode/codec) is pure bytes; parallelism enters only
through the Communicator + positioned-I/O backend, exactly as in the paper
where the format is defined independently of MPI.
"""
from repro_torch.core.errors import ScdaError, ScdaErrorCode, ferror_string
from repro_torch.core import spec, encode, codec, partition, pipeline
from repro_torch.core.comm import (Communicator, SerialComm, ThreadComm,
                                   run_ranks)
from repro_torch.core.io_backend import FileBackend
from repro_torch.core.writer import (ScdaWriter, fopen_write, fopen_append,
                               DEFAULT_VENDOR)
from repro_torch.core.reader import (ScdaReader, SectionHeader, fopen_read,
                               scan_sections)
from repro_torch.core.index import IndexEntry, ScdaIndex

__all__ = [
    "ScdaError", "ScdaErrorCode", "ferror_string",
    "spec", "encode", "codec", "partition", "pipeline",
    "Communicator", "SerialComm", "ThreadComm",
    "run_ranks", "FileBackend",
    "ScdaWriter", "fopen_write", "fopen_append", "DEFAULT_VENDOR",
    "ScdaReader", "SectionHeader", "fopen_read", "scan_sections",
    "IndexEntry", "ScdaIndex",
]
