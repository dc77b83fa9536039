"""Byte-exact primitives of the scda format (paper §2).

Everything in this module is a pure function over ``bytes`` — no I/O, no
parallelism.  The parallel writer/reader and the serial oracle encoder are
built strictly on top of these primitives, so format conformance is testable
in one place.

Layout summary (paper Figures 1–5):

  file header F (128 B) = magic(7) ' ' pad('-', vendor → 24)        | 32 B
                          'F' ' ' pad('-', user → 62)               | 64 B
                          pad('=', 0 data bytes → 32)               | 32 B
  inline I     (96 B)  = 'I' ' ' pad('-', user → 62)  + data(32)
  block B              = 'B' ' ' pad('-', user → 62)
                         'E' ' ' pad('-', decimal E → 30)
                         data(E) + pad('=')
  array A              = 'A' header + 'N' entry + 'E' entry + data(N·E) + pad('=')
  varray V             = 'V' header + 'N' entry + N × 'E' entries + data(ΣEᵢ) + pad('=')

Two padding disciplines (§2.1):
  pad('-' to d):  input n ≤ d−4 →  ' ' + (p−3)ד-” + q,  p = d−n,
                  q = "-\n" (Unix) | "\r\n" (MIME).  Invertible from the right.
  pad('=' mod D): D = 32, p ∈ [7, 38] unique with (n+p) % 32 == 0,
                  = P + Qד=” + R with P/Q/R per Table 1; ends in a blank line.
"""
from __future__ import annotations

import dataclasses
import functools as _functools
from typing import List, Optional, Sequence, Tuple

try:  # numpy powers the vectorized count-entry fast paths; optional.
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is a hard dep elsewhere
    _np = None

from repro_torch.core.errors import ScdaError, ScdaErrorCode

# --------------------------------------------------------------------------
# Format constants (paper §2, Figure 1)
# --------------------------------------------------------------------------

#: scda format identifier byte (paper Fig. 1): (da)₁₆ = 218.
MAGIC_IDENT = 0xDA
#: Current format version (paper Fig. 1): counts from (a0)₁₆ to (ff)₁₆.
FORMAT_VERSION = 0xA0
#: The 7 magic bytes, ``sc%02xt%02x`` → b"scdata0" for version a0.
MAGIC = b"sc%02xt%02x" % (MAGIC_IDENT, FORMAT_VERSION)
assert MAGIC == b"scdata0" and len(MAGIC) == 7

#: Entry geometry.
VENDOR_FIELD = 24          # vendor string padded width (Fig. 1)
VENDOR_MAX = VENDOR_FIELD - 4          # = 20
USER_FIELD = 62            # user string padded width (Figs. 1–5)
USER_MAX = USER_FIELD - 4              # = 58
COUNT_FIELD = 30           # decimal count padded width (Figs. 3–5)
COUNT_MAX_DIGITS = COUNT_FIELD - 4     # = 26
COUNT_MAX = 10**COUNT_MAX_DIGITS - 1
COUNT_ENTRY_BYTES = 32     # letter + ' ' + padded count
SECTION_HEADER_BYTES = 64  # type letter + ' ' + padded user string
DATA_PAD_DIV = 32          # D in §2.1.2
FILE_HEADER_BYTES = 128
INLINE_DATA_BYTES = 32
INLINE_SECTION_BYTES = SECTION_HEADER_BYTES + INLINE_DATA_BYTES  # 96

SECTION_TYPES = (b"I", b"B", b"A", b"V")

#: Line-break styles (§2.1): the writer chooses; readers accept either.
UNIX = "unix"
MIME = "mime"
_FIXED_Q = {UNIX: b"-\n", MIME: b"\r\n"}


# --------------------------------------------------------------------------
# §2.1.1 — '-' padding of strings and counts to a fixed width
# --------------------------------------------------------------------------

def pad_fixed(data: bytes, d: int, style: str = UNIX) -> bytes:
    """Right-pad ``data`` (n ≤ d−4) to exactly ``d`` bytes per §2.1.1 (1)."""
    n = len(data)
    if n > d - 4:
        raise ScdaError(ScdaErrorCode.ARG_USER_STRING,
                        f"{n} bytes exceeds field capacity {d - 4}")
    p = d - n
    return data + b" " + b"-" * (p - 3) + _FIXED_Q[style]


def unpad_fixed(padded: bytes, d: int) -> bytes:
    """Invert :func:`pad_fixed`: parse from the right to infer p, return data.

    Either line-break style is accepted (§2.1: the writer's choice has no
    effect on reading).  Raises CORRUPT_PADDING on malformed padding.
    """
    if len(padded) != d:
        raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                        f"field is {len(padded)} bytes, expected {d}")
    q = padded[-2:]
    if q not in (b"-\n", b"\r\n"):
        raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                        f"bad terminal bytes {q!r}")
    # Scan dashes backwards from d-3 until the single space separator.
    i = d - 3
    while i >= 0 and padded[i:i + 1] == b"-":
        i -= 1
    if i < 0 or padded[i:i + 1] != b" ":
        raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                        "missing space before dash padding")
    n = i
    p = d - n
    if p < 4:
        raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                        f"padding only {p} bytes, minimum is 4")
    return padded[:n]


# --------------------------------------------------------------------------
# §2.1.2 — '=' padding of data bytes to a multiple of 32
# --------------------------------------------------------------------------

def data_pad_length(n: int) -> int:
    """The unique p ∈ [7, 38] with (n + p) divisible by 32."""
    p = (-n) % DATA_PAD_DIV
    if p < 7:
        p += DATA_PAD_DIV
    return p


def pad_data(n: int, last_byte: Optional[int], style: str = UNIX) -> bytes:
    """The data padding for ``n`` input bytes whose final byte is ``last_byte``.

    ``last_byte`` is ``None`` iff n == 0.  Per §2.1.2 and Table 1:
    P = "==" if the input ends in a line feed, else "\\n=" (Unix) / "\\r\\n"
    (MIME); then Q '=' bytes and R = "\\n\\n" (Unix) / "\\r\\n\\r\\n" (MIME).
    """
    # The padding depends only on (n mod 32, ends-in-LF, style) — memoize.
    return _pad_data_cached(n % DATA_PAD_DIV,
                            n > 0 and last_byte == 0x0A, style)


@_functools.lru_cache(maxsize=None)  # 32 × 2 × 2 keys
def _pad_data_cached(n: int, ends_lf: bool, style: str) -> bytes:
    p = data_pad_length(n)
    if ends_lf:
        head = b"=="
    elif style == MIME:
        head = b"\r\n"
    else:
        head = b"\n="
    if style == MIME:
        return head + b"=" * (p - 6) + b"\r\n\r\n"
    return head + b"=" * (p - 4) + b"\n\n"


def check_data_pad(pad: bytes, n: int, last_byte: Optional[int]) -> None:
    """Validate data padding leniently.

    §2.1.2: "If neither MIME nor Unix line endings are desired, the data
    padding may consist of p arbitrary bytes" — so only the *length* is
    normative.  We still sanity-check the length (the byte count is always
    inferable from the preceding file contents).
    """
    if len(pad) != data_pad_length(n):
        raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                        f"data padding is {len(pad)} bytes, expected "
                        f"{data_pad_length(n)} for {n} data bytes")


# --------------------------------------------------------------------------
# Count entries ('E', 'N', and the §3 'U' convention)
# --------------------------------------------------------------------------

def format_count(value: int) -> bytes:
    """Decimal without leading spaces or zeros (§2.4), ≤ 26 digits."""
    if not isinstance(value, int) or isinstance(value, bool):
        raise ScdaError(ScdaErrorCode.ARG_COUNT_RANGE, f"{value!r} not an int")
    if value < 0 or value > COUNT_MAX:
        raise ScdaError(ScdaErrorCode.ARG_COUNT_RANGE, str(value))
    return str(value).encode("ascii")


def count_entry(letter: bytes, value: int, style: str = UNIX) -> bytes:
    """A 32-byte count entry: letter, ' ', decimal padded('-' to 30)."""
    if type(value) is int:  # excludes bool / np integers: uncached strict path
        return _count_entry_cached(letter, value, style)
    return _count_entry_impl(letter, value, style)


def _count_entry_impl(letter: bytes, value: int, style: str) -> bytes:
    assert len(letter) == 1
    return letter + b" " + pad_fixed(format_count(value), COUNT_FIELD, style)


_count_entry_cached = _functools.lru_cache(maxsize=4096)(_count_entry_impl)


# -- vectorized batch codec for count entries --------------------------------
# Varrays carry one 32-byte 'E' entry per element; generating/parsing them
# one Python call at a time is the O(N) hot loop the §A.4.4/§A.5.5 paths hit
# hardest.  These batch versions are byte-identical to count_entry /
# parse_count_entry (the scalar functions remain the oracle and the
# fallback for exotic inputs: values beyond int64, malformed entries).

#: Smallest batch worth the numpy fixed overhead.
_VEC_MIN = 4
#: 10^1 .. 10^18 — decimal-length table covering the whole int64 range.
_P10 = None if _np is None else 10 ** _np.arange(1, 19, dtype=_np.int64)
#: 10^0 .. 10^18 — positional-weight lookup for the batch parser.
_P10_W = None if _np is None else 10 ** _np.arange(0, 19, dtype=_np.int64)
_P10_DESC: dict = {}
_ENTRY_TEMPLATE: dict = {}


def _is_plain_int(v) -> bool:
    return type(v) is int


def _entry_template(letter: int, style: str):
    key = (letter, style)
    t = _ENTRY_TEMPLATE.get(key)
    if t is None:
        q = _FIXED_Q[style]
        t = _np.full(COUNT_ENTRY_BYTES, ord("-"), _np.uint8)
        t[0], t[1] = letter, 0x20
        t[30], t[31] = q[0], q[1]
        _ENTRY_TEMPLATE[key] = t
    return t


def _p10_desc(L: int):
    p = _P10_DESC.get(L)
    if p is None:
        p = 10 ** _np.arange(L - 1, -1, -1, dtype=_np.int64)
        _P10_DESC[L] = p
    return p


def count_entries(letter: bytes, values: Sequence[int],
                  style: str = UNIX, trusted_ints: bool = False) -> bytes:
    """``b"".join(count_entry(letter, v, style) for v in values)``, fast.

    Vectorized with numpy for int64-representable values; falls back to the
    scalar oracle otherwise (including for range/type errors, so error
    behavior is identical).  ``trusted_ints`` skips the per-element plain-int
    pre-screen — pass it ONLY for lists built from ``len()`` (a float/bool
    smuggled into a trusted list could be coerced instead of rejected).
    """
    n = len(values)
    if n == 0:
        return b""
    is_int_list = (type(values) in (list, tuple)
                   and (trusted_ints or all(map(_is_plain_int, values))))
    if is_int_list and n >= _VEC_MIN:
        first = values[0]
        if first >= 0 and values.count(first) == n:
            # Uniform Python-int values: replicate one oracle entry with
            # no numpy round-trip at all.
            return count_entry(letter, first, style) * n
    vals = None
    if _np is not None and n >= _VEC_MIN and (
            is_int_list or isinstance(values, _np.ndarray)):
        # Lists are pre-screened for plain ints above so np.asarray can
        # never silently coerce a float/bool the scalar oracle rejects.
        arr = _np.asarray(values)
        if (arr.ndim == 1 and arr.dtype.kind in "iu"
                and not (arr.dtype.kind == "u" and arr.dtype.itemsize == 8
                         and int(arr.max()) > 2 ** 63 - 1)):
            vals = arr.astype(_np.int64, copy=False)
            first = int(vals[0])
            if first >= 0 and bool((vals == first).all()):
                # Uniform values — the dominant real shape (fixed-size
                # chunks, U-entry arrays): one oracle entry, replicated.
                return count_entry(letter, first, style) * n
            if int(vals.min()) < 0:
                vals = None  # scalar path raises ARG_COUNT_RANGE
    if vals is None:
        # numpy integer scalars are not Python ints; unwrap them so the
        # scalar oracle's type validation stays strict for everything else.
        return b"".join(
            count_entry(letter,
                        int(v) if _np is not None
                        and isinstance(v, _np.integer) else v, style)
            for v in values)

    lens = _np.searchsorted(_P10, vals, side="right") + 1
    min_l, max_l = int(lens.min()), int(lens.max())
    buf = _np.empty((n, COUNT_ENTRY_BYTES), _np.uint8)
    buf[:] = _entry_template(letter[0], style)
    digs = vals[:, None] // _p10_desc(max_l)
    digs %= 10
    digs += ord("0")
    if min_l == max_l:  # uniform digit count — direct placement
        buf[:, 2:2 + max_l] = digs
        buf[:, 2 + max_l] = 0x20
    else:
        # ``digs`` is right-aligned (leading zeros); build a wide row of
        # [digits | ' ' | dashes] and gather each row's 28-byte tail
        # (digits + ' ' + dashes always total 28) with one shifted take.
        src = _np.full((n, max_l + COUNT_FIELD - 2), ord("-"), _np.uint8)
        src[:, :max_l] = digs
        src[:, max_l] = 0x20
        idx = _np.arange(COUNT_FIELD - 2)[None, :] + (max_l - lens)[:, None]
        buf[:, 2:COUNT_FIELD] = _np.take_along_axis(src, idx, 1)
    return buf.tobytes()


def parse_count_entries(raw: bytes, letter: Optional[bytes],
                        n: int) -> List[int]:
    """Parse ``n`` consecutive 32-byte count entries from ``raw``.

    ``letter=None`` accepts any entry letter (the §A.5.1 skip path).  Any
    malformed entry routes through the scalar parser so the error code and
    message match :func:`parse_count_entry` exactly.
    """
    if n == 0:
        return []
    if len(raw) != n * COUNT_ENTRY_BYTES:
        raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"entry batch is {len(raw)} bytes, expected "
                        f"{n * COUNT_ENTRY_BYTES}")
    if _np is None or n < _VEC_MIN:
        return _parse_count_entries_scalar(raw, letter, n)
    a = _np.frombuffer(raw, _np.uint8).reshape(n, COUNT_ENTRY_BYTES)
    ok = a[:, 1] == 0x20
    if letter is not None:
        ok &= a[:, 0] == letter[0]
    q0, q1 = a[:, 30], a[:, 31]
    ok &= ((q0 == 0x2D) & (q1 == 0x0A)) | ((q0 == 0x0D) & (q1 == 0x0A))
    body = a[:, 2:COUNT_FIELD]
    isdig = (body >= 0x30) & (body <= 0x39)
    lens = isdig.argmin(1)  # first non-digit column == digit count
    ok &= (lens >= 1) & (lens <= COUNT_MAX_DIGITS)
    j = _np.arange(COUNT_FIELD - 2)
    after = j[None, :] - lens[:, None]  # <0 digit, ==0 space, >0 dash
    ok &= _np.where(after < 0, isdig,
                    _np.where(after == 0, body == 0x20,
                              body == 0x2D)).all(1)
    ok &= (a[:, 2] != 0x30) | (lens == 1)  # no leading zeros
    # Values with >18 digits overflow int64 — punt those to the scalar
    # parser too (legal up to 26 digits, just astronomically rare).
    max_l = int(lens.max())
    if not bool(ok.all()) or max_l > 18:
        return _parse_count_entries_scalar(raw, letter, n)
    exp = lens[:, None] - 1 - j[:max_l]
    weights = _P10_W[_np.clip(exp, 0, 18)]
    weights[exp < 0] = 0
    digits = body[:, :max_l].astype(_np.int64)
    digits -= 0x30
    vals = (digits * weights).sum(1)
    return vals.tolist()


def _parse_count_entries_scalar(raw: bytes, letter: Optional[bytes],
                                n: int) -> List[int]:
    out = []
    for i in range(n):
        entry = raw[i * COUNT_ENTRY_BYTES:(i + 1) * COUNT_ENTRY_BYTES]
        out.append(parse_count_entry(
            entry, entry[0:1] if letter is None else letter))
    return out


def parse_count_entry(entry: bytes, letter: bytes) -> int:
    """Parse and validate a 32-byte count entry."""
    if len(entry) != COUNT_ENTRY_BYTES:
        raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"count entry is {len(entry)} bytes")
    if entry[0:1] != letter or entry[1:2] != b" ":
        raise ScdaError(ScdaErrorCode.CORRUPT_COUNT,
                        f"expected {letter!r} entry, got {entry[:2]!r}")
    digits = unpad_fixed(entry[2:], COUNT_FIELD)
    if not digits or not digits.isdigit():
        raise ScdaError(ScdaErrorCode.CORRUPT_COUNT, repr(digits))
    if len(digits) > COUNT_MAX_DIGITS:
        raise ScdaError(ScdaErrorCode.CORRUPT_COUNT,
                        f"{len(digits)} digits exceeds {COUNT_MAX_DIGITS}")
    value = int(digits)
    if str(value).encode() != digits:  # no leading zeros (except "0")
        raise ScdaError(ScdaErrorCode.CORRUPT_COUNT,
                        f"leading zeros in {digits!r}")
    return value


# --------------------------------------------------------------------------
# Section headers and the file header
# --------------------------------------------------------------------------

def section_header(type_letter: bytes, user_string: bytes,
                   style: str = UNIX) -> bytes:
    """The 64-byte 'section type and user string' entry."""
    return _section_header_cached(bytes(type_letter), bytes(user_string),
                                  style)


@_functools.lru_cache(maxsize=1024)
def _section_header_cached(type_letter: bytes, user_string: bytes,
                           style: str) -> bytes:
    assert len(type_letter) == 1
    if len(user_string) > USER_MAX:
        raise ScdaError(ScdaErrorCode.ARG_USER_STRING,
                        f"{len(user_string)} > {USER_MAX}")
    return type_letter + b" " + pad_fixed(user_string, USER_FIELD, style)


def parse_section_header(entry: bytes) -> Tuple[bytes, bytes]:
    """Parse a 64-byte section header → (type letter, user string)."""
    if len(entry) != SECTION_HEADER_BYTES:
        raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"section header is {len(entry)} bytes")
    letter = entry[0:1]
    if entry[1:2] != b" ":
        raise ScdaError(ScdaErrorCode.CORRUPT_SECTION_TYPE,
                        f"missing separator after type {letter!r}")
    user = unpad_fixed(entry[2:], USER_FIELD)
    return letter, user


def file_header(vendor: bytes, user_string: bytes, style: str = UNIX,
                version: int = FORMAT_VERSION) -> bytes:
    """The 128-byte file header section F (paper Fig. 1)."""
    if len(vendor) > VENDOR_MAX:
        raise ScdaError(ScdaErrorCode.ARG_VENDOR_STRING,
                        f"{len(vendor)} > {VENDOR_MAX}")
    if not (0xA0 <= version <= 0xFF):
        raise ScdaError(ScdaErrorCode.ARG_COUNT_RANGE,
                        f"version {version:#x} outside [a0, ff]")
    magic = b"sc%02xt%02x" % (MAGIC_IDENT, version)
    row1 = magic + b" " + pad_fixed(vendor, VENDOR_FIELD, style)
    row2 = section_header(b"F", user_string, style)
    row3 = pad_data(0, None, style)  # zero data bytes → 32 pad bytes
    out = row1 + row2 + row3
    assert len(out) == FILE_HEADER_BYTES
    return out


@dataclasses.dataclass(frozen=True)
class FileHeader:
    version: int
    vendor: bytes
    user_string: bytes


def detect_style(header: bytes) -> str:
    """Infer the writer's line-break style from a 128-byte file header.

    §2.1 leaves the style to the writer and makes reading independent of
    it — but mode-'a' appends must *reproduce* the original choice so the
    grown file stays byte-identical to a single serial session.  The
    vendor field's terminal bytes (q = "-\\n" Unix, "\\r\\n" MIME) carry
    exactly that bit.
    """
    if len(header) < VENDOR_FIELD + 8:
        raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"file header is {len(header)} bytes")
    q = header[VENDOR_FIELD + 8 - 2:VENDOR_FIELD + 8]
    if q == _FIXED_Q[MIME]:
        return MIME
    if q == _FIXED_Q[UNIX]:
        return UNIX
    raise ScdaError(ScdaErrorCode.CORRUPT_PADDING,
                    f"vendor field terminal bytes {q!r} match neither "
                    f"line-break style")


def parse_file_header(buf: bytes) -> FileHeader:
    """Parse and validate the 128-byte file header."""
    if len(buf) != FILE_HEADER_BYTES:
        raise ScdaError(ScdaErrorCode.CORRUPT_TRUNCATED,
                        f"file header is {len(buf)} bytes")
    magic = buf[:7]
    if magic[:2] != b"sc" or magic[4:5] != b"t":
        raise ScdaError(ScdaErrorCode.CORRUPT_MAGIC, repr(magic))
    try:
        ident = int(magic[2:4], 16)
        version = int(magic[5:7], 16)
    except ValueError as e:
        raise ScdaError(ScdaErrorCode.CORRUPT_MAGIC, repr(magic)) from e
    if ident != MAGIC_IDENT:
        raise ScdaError(ScdaErrorCode.CORRUPT_MAGIC,
                        f"identifier {ident:#x} is not scda ({MAGIC_IDENT:#x})")
    if not (0xA0 <= version <= 0xFF):
        raise ScdaError(ScdaErrorCode.CORRUPT_MAGIC,
                        f"version {version:#x} outside [a0, ff]")
    if buf[7:8] != b" ":
        raise ScdaError(ScdaErrorCode.CORRUPT_MAGIC, "missing magic separator")
    vendor = unpad_fixed(buf[8:32], VENDOR_FIELD)
    letter, user = parse_section_header(buf[32:96])
    if letter != b"F":
        raise ScdaError(ScdaErrorCode.CORRUPT_SECTION_TYPE,
                        f"file header section letter {letter!r}")
    check_data_pad(buf[96:128], 0, None)
    return FileHeader(version=version, vendor=vendor, user_string=user)


# --------------------------------------------------------------------------
# Section size arithmetic (used by writer/reader cursor bookkeeping)
# --------------------------------------------------------------------------

def padded_data_bytes(n: int) -> int:
    """Bytes occupied on disk by an n-byte data payload plus its padding."""
    return n + data_pad_length(n)


def inline_section_bytes() -> int:
    return INLINE_SECTION_BYTES


def block_section_bytes(E: int) -> int:
    return SECTION_HEADER_BYTES + COUNT_ENTRY_BYTES + padded_data_bytes(E)


def array_section_bytes(N: int, E: int) -> int:
    return (SECTION_HEADER_BYTES + 2 * COUNT_ENTRY_BYTES
            + padded_data_bytes(N * E))


def varray_section_bytes(N: int, total_data: int) -> int:
    return (SECTION_HEADER_BYTES + (1 + N) * COUNT_ENTRY_BYTES
            + padded_data_bytes(total_data))


# §3 encoded sections span two physical sections; their combined extents
# (scdatool fsck cross-checks the reader's cursor walk against these).

def encoded_block_section_bytes(compressed_E: int) -> int:
    """§3.2 — I(magic, U-entry) followed by B(user, compressed)."""
    return INLINE_SECTION_BYTES + block_section_bytes(compressed_E)


def encoded_array_section_bytes(N: int, total_compressed: int) -> int:
    """§3.3 — I(magic, U-entry) followed by the carrier V section."""
    return INLINE_SECTION_BYTES + varray_section_bytes(N, total_compressed)


def encoded_varray_section_bytes(N: int, total_compressed: int) -> int:
    """§3.4 — A(magic, N, 32, U-entries) followed by the carrier V."""
    return (array_section_bytes(N, COUNT_ENTRY_BYTES)
            + varray_section_bytes(N, total_compressed))
