"""Error taxonomy for the scda format library (paper §A.6).

The paper mandates that file errors never crash a simulation: every API call
reports an error code that the caller can react to.  In Python we raise
:class:`ScdaError` carrying an :class:`ScdaErrorCode`; the training loop
catches these and keeps running (fault tolerance).  ``ferror_string`` mirrors
``scda_ferror_string`` for code→string translation.

Three groups of checked runtime errors (paper §A.6):
  (1) corrupt file contents,
  (2) file system errors,
  (3) semantically invalid input parameters or call sequence.
"""
from __future__ import annotations

import enum
import errno as _errno


class ScdaErrorCode(enum.IntEnum):
    SUCCESS = 0

    # -- group 1: corrupt file contents ------------------------------------
    CORRUPT_MAGIC = 101          # bad magic bytes / unsupported version
    CORRUPT_PADDING = 102        # '-' or '=' padding malformed
    CORRUPT_COUNT = 103          # count entry not a valid decimal
    CORRUPT_SECTION_TYPE = 104   # section letter not in {I,B,A,V}
    CORRUPT_TRUNCATED = 105      # file ends mid-section
    CORRUPT_ENCODING = 106       # §3 compression convention violated
    CORRUPT_CHECKSUM = 107       # adler32 / size mismatch on inflate

    # -- group 2: file system errors ----------------------------------------
    FS_OPEN = 201
    FS_READ = 202
    FS_WRITE = 203
    FS_CLOSE = 204

    # -- group 3: invalid parameters / call sequence ------------------------
    ARG_USER_STRING = 301        # user string exceeds 58 bytes
    ARG_VENDOR_STRING = 302      # vendor string exceeds 20 bytes
    ARG_COUNT_RANGE = 303        # count negative or > 26 decimal digits
    ARG_INLINE_SIZE = 304        # inline data not exactly 32 bytes
    ARG_PARTITION = 305          # partition counts inconsistent / non-collective
    ARG_MODE = 306               # bad open mode
    ARG_SEQUENCE = 307           # reading functions improperly composed
    ARG_DATA_SIZE = 308          # local data does not match declared sizes


_ERROR_STRINGS = {
    ScdaErrorCode.SUCCESS: "success",
    ScdaErrorCode.CORRUPT_MAGIC: "corrupt file: bad magic bytes or unsupported scda version",
    ScdaErrorCode.CORRUPT_PADDING: "corrupt file: malformed padding",
    ScdaErrorCode.CORRUPT_COUNT: "corrupt file: malformed count entry",
    ScdaErrorCode.CORRUPT_SECTION_TYPE: "corrupt file: unknown section type",
    ScdaErrorCode.CORRUPT_TRUNCATED: "corrupt file: unexpected end of file",
    ScdaErrorCode.CORRUPT_ENCODING: "corrupt file: compression convention violated",
    ScdaErrorCode.CORRUPT_CHECKSUM: "corrupt file: checksum or size mismatch on decompression",
    ScdaErrorCode.FS_OPEN: "file system: cannot open file",
    ScdaErrorCode.FS_READ: "file system: read failed",
    ScdaErrorCode.FS_WRITE: "file system: write failed",
    ScdaErrorCode.FS_CLOSE: "file system: close failed",
    ScdaErrorCode.ARG_USER_STRING: "invalid argument: user string exceeds 58 bytes",
    ScdaErrorCode.ARG_VENDOR_STRING: "invalid argument: vendor string exceeds 20 bytes",
    ScdaErrorCode.ARG_COUNT_RANGE: "invalid argument: count out of 26-decimal-digit range",
    ScdaErrorCode.ARG_INLINE_SIZE: "invalid argument: inline data must be exactly 32 bytes",
    ScdaErrorCode.ARG_PARTITION: "invalid argument: inconsistent partition",
    ScdaErrorCode.ARG_MODE: "invalid argument: bad file open mode",
    ScdaErrorCode.ARG_SEQUENCE: "invalid argument: improper call sequence",
    ScdaErrorCode.ARG_DATA_SIZE: "invalid argument: local data size mismatch",
}


class ScdaError(Exception):
    """Exception carrying an scda error code (paper §A.6).

    ``offset``, when known, is the absolute file offset of the first byte
    that failed validation — ``scdatool fsck`` and the mode-'a' tail
    validation surface it so "trailing garbage" findings point at the
    exact boundary instead of just the enclosing section.
    """

    def __init__(self, code: ScdaErrorCode, detail: str = "",
                 offset: "int | None" = None):
        self.code = ScdaErrorCode(code)
        self.detail = detail
        self.offset = offset
        msg = ferror_string(self.code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)

    def at(self, offset: int) -> "ScdaError":
        """Attach ``offset`` if none is recorded yet (callers lower in the
        stack know the tighter position; never overwrite it)."""
        if self.offset is None:
            self.offset = offset
        return self

    @property
    def group(self) -> int:
        """Error group per paper §A.6: 1 corrupt, 2 file system, 3 usage."""
        return int(self.code) // 100


def ferror_string(code: int) -> str:
    """Translate an error code to a string (paper §A.6.1, non-collective)."""
    try:
        return _ERROR_STRINGS[ScdaErrorCode(code)]
    except (ValueError, KeyError):
        return f"unknown scda error code {code}"


#: Errno values the backend treats as transient and retries (bounded by
#: ``REPRO_SCDA_RETRIES``) instead of aborting: an interrupted syscall
#: and a would-block return are scheduling noise, not file damage.
TRANSIENT_ERRNOS = frozenset({
    _errno.EINTR, _errno.EAGAIN,
    getattr(_errno, "EWOULDBLOCK", _errno.EAGAIN),
})


def os_error_detail(path: str, offset: "int | None", e: OSError,
                    retries: int = 0) -> str:
    """The detail string for a group-2 error wrapping ``e``.

    Uniform across the backend's read/write paths: the failing
    ``path@offset``, the OS error, how many transient retries were burned
    before giving up, and — loudest of all — an explicit marker for
    ENOSPC, the one errno whose cleanup contract (tmp sweep, no visible
    checkpoint) callers must be able to trust.
    """
    loc = f"{path}@{offset}" if offset is not None else path
    msg = f"{loc}: {e}"
    if retries:
        msg += f" (gave up after {retries} transient retries)"
    if getattr(e, "errno", None) == _errno.ENOSPC:
        msg += (" — NO SPACE LEFT ON DEVICE; aborting this save cleanly"
                " (tmp files are swept, no partial checkpoint becomes"
                " visible)")
    return msg
