"""Quickstart: the scda format in five minutes, through the PyTorch port's
core (``repro_torch.core``) — the counterpart of ``quickstart.py``.

Writes a file with every section type (inline / block / fixed array /
variable array, raw + compressed), proves serial-equivalence by rewriting
the same data under a 3-rank partition, then reads it back under a
different partition and inspects the file with a dumb byte-level scanner.
The format layer touches no tensor, so this runs on the host.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
import os
import tempfile

from repro_torch.core import (ThreadComm, fopen_read, fopen_write,
                              partition, run_ranks, scan_sections)


def main(argv=None):
    """Write, rewrite on 3 ranks, re-read on 2, scan; returns the file's
    path, its size, whether the 3-rank file is the serial one, and the
    scanned sections."""
    del argv   # no options
    # SCDA_EXAMPLE_DIR pins the output location (so scdatool can be run
    # over the files this example writes).
    tmp = os.environ.get("SCDA_EXAMPLE_DIR")
    if tmp:
        os.makedirs(tmp, exist_ok=True)
    else:
        tmp = tempfile.mkdtemp(prefix="scda-quickstart-")
    path = os.path.join(tmp, "demo.scda")

    # -- write (serial) ------------------------------------------------------
    mesh_sizes = [3, 0, 47, 12, 1, 9]          # a "hybrid mesh": ragged cells
    mesh_cells = [os.urandom(s) for s in mesh_sizes]
    with fopen_write(None, path, user_string=b"quickstart demo") as f:
        f.write_inline(b"status", b"step 000042 t 1.25e-3 ok.......\n")
        f.write_block(b"run config", b"alpha = 0.1\nbeta = 2\n")
        f.write_array(b"node coords", bytes(range(240)), [10], 24)
        f.write_varray(b"cells", mesh_cells, [6], mesh_sizes, encode=True)
    size = os.path.getsize(path)
    print(f"wrote {size} bytes to {path}")

    # -- serial-equivalence: rewrite in parallel, compare bytes --------------
    path3 = os.path.join(tmp, "demo-3ranks.scda")
    counts, vcounts = [4, 2, 4], [2, 2, 2]
    offs, voffs = partition.offsets(counts), partition.offsets(vcounts)

    def rank_write(comm):
        data = bytes(range(240))
        with fopen_write(comm, path3, user_string=b"quickstart demo") as f:
            f.write_inline(b"status",
                           b"step 000042 t 1.25e-3 ok.......\n"
                           if comm.rank == 0 else None)
            f.write_block(b"run config",
                          b"alpha = 0.1\nbeta = 2\n"
                          if comm.rank == 0 else None, E=21)
            f.write_array(b"node coords",
                          data[offs[comm.rank] * 24:offs[comm.rank + 1] * 24],
                          counts, 24)
            f.write_varray(b"cells",
                           mesh_cells[voffs[comm.rank]:voffs[comm.rank + 1]],
                           vcounts,
                           mesh_sizes[voffs[comm.rank]:voffs[comm.rank + 1]],
                           encode=True)

    run_ranks(ThreadComm.group(3), rank_write)
    same = open(path, "rb").read() == open(path3, "rb").read()
    print(f"serial file == 3-rank file: {same}")
    assert same

    # -- read under a different partition -------------------------------------
    def rank_read(comm):
        with fopen_read(comm, path) as r:
            r.read_section_header(); r.skip_data()       # status
            r.read_section_header(); r.skip_data()       # config
            hdr = r.read_section_header()                # node coords
            mine = r.read_array_data([5, 5], hdr.E)      # new partition!
            hdr = r.read_section_header(decode=True)     # cells (decoded)
            sizes = r.read_varray_sizes([3, 3])
            cells = r.read_varray_data([3, 3], sizes)
            return b"".join(mine), cells

    parts = run_ranks(ThreadComm.group(2), rank_read)
    assert parts[0][0] + parts[1][0] == bytes(range(240))
    assert parts[0][1] + parts[1][1] == mesh_cells
    print("re-read under 2-rank partition: data identical")

    # -- inspect: any conforming reader can walk the file ---------------------
    print("\nsections (decode=True):")
    sections = []
    for h in scan_sections(path):
        print(f"  {h.type}  user={h.user_string!r:28} N={h.N:<4} E={h.E:<4} "
              f"decoded={h.decoded}")
        sections.append((h.type, h.user_string.decode("latin-1"), h.N,
                         h.E, h.decoded))
    return {"path": path, "bytes": size, "serial_equivalent": same,
            "sections": sections}


if __name__ == "__main__":
    main()
