#!/usr/bin/env python
"""Host seconds of a cold build's SQLite read in the port, with and without
the read connections' memory map.

    python3 scripts/sqlite_read_times.py [--rows N] [--dim D] [--turns T] [--dir DIR]

Writes a database of N items with one D-wide f32 embedding each (seeded
numpy rows, model 0 version 0) through the port's schema under DIR (a
temporary directory by default), then reads every embedding back as
``Searcher.build`` does (``Searcher._BUILD_SQL`` through
``Database.read()``, fetchmany chunks of ``_LOAD_DB_CHUNK_ROWS``, the
BLOBs joined into one f32 array, the chunk keys) in a fresh process for
each run: ``READ_MMAP_BYTES`` as the port sets it ("mmap") and 0 ("read"),
in turns (mmap, read, read, mmap, ...) for T pairs.  The page cache is
warm after the write.  Prints each run and one JSON line of the seconds.
Needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
READ = r"""
import sys, time
import numpy as np
from perceive_tpu_torch.db import database
from perceive_tpu_torch.index.searcher import Searcher
path, mm, dim = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
database.READ_MMAP_BYTES = mm
t0 = time.perf_counter()
db = database.Database(path)
conn = db.read()
cur = conn.execute(Searcher._BUILD_SQL, (0, 0))
n = 0
while True:
    rows = cur.fetchmany(Searcher._LOAD_DB_CHUNK_ROWS)
    if not rows:
        break
    vecs = np.frombuffer(b"".join(r[2] for r in rows), dtype="<f4").reshape(len(rows), dim)
    keys = [r[0] * Searcher._CHUNK_STRIDE + r[3] for r in rows]
    n += len(rows)
print(n, time.perf_counter() - t0, conn.execute("PRAGMA mmap_size").fetchone()[0])
db.close()
"""


def write_rows(path: str, n: int, dim: int) -> float:
    """n items with one embedding each, in transactions of 500,000 rows."""
    sys.path.insert(0, str(REPO))
    from perceive_tpu_torch.db import Database, add_source
    from perceive_tpu_torch.types import Source

    db = Database(path)
    src = add_source(db, Source(name="rows", config={"type": "fs"}, location="generated:rows"))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for lo in range(0, n, 500_000):
        ids = range(lo + 1, min(n, lo + 500_000) + 1)
        v = rng.standard_normal((len(ids), dim), dtype=np.float32)
        with db.write() as txn:
            txn.executemany(
                """INSERT INTO items (id, source_id, external_id, version, hash, content, process_version)
                   VALUES (?,?,?,?,?,?,?)""",
                ((i, src.id, f"row{i}", 1, "", "sixteen words of filler text", 0) for i in ids))
            txn.executemany(
                """INSERT INTO item_embeddings (item_id, chunk_idx, item_index_version, embedding, model_id,
                     model_version, seq) VALUES (?,?,?,?,?,?,?)""",
                ((i, 0, 1, v[j].tobytes(), 0, 0, i) for j, i in enumerate(ids)))
    db.close()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--turns", type=int, default=2, help="pairs of runs (mmap, read) in alternating order")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from perceive_tpu_torch.db.database import READ_MMAP_BYTES

    with tempfile.TemporaryDirectory(dir=args.dir) as wd:
        path = os.path.join(wd, "rows.sqlite3")
        took = write_rows(path, args.rows, args.dim)
        print(f"wrote {args.rows} rows of {args.dim} in {took:.1f} s; file {os.path.getsize(path) / 2**30:.3f} GiB",
              flush=True)
        order = [("mmap", "read"), ("read", "mmap")]
        seconds = {"mmap": [], "read": []}
        for t in range(args.turns):
            for how in order[t % 2]:
                mm = READ_MMAP_BYTES if how == "mmap" else 0
                r = subprocess.run([sys.executable, "-c", READ, path, str(mm), str(args.dim)], cwd=str(REPO),
                                   capture_output=True, text=True, check=True)
                n, s, mapped = r.stdout.split()
                if int(n) != args.rows:
                    raise SystemExit(f"read {n} rows, want {args.rows}")
                seconds[how].append(float(s))
                print(f"{how}: {n} rows in {float(s):.3f} s (mmap_size {mapped})", flush=True)
    print(json.dumps({"rows": args.rows, "dim": args.dim, "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
