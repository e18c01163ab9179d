"""A copy of perceive_tpu/paths.py, so that the port imports nothing of the JAX
package (tests/test_torch_db.py holds the two schemas equal).

Default data-directory resolution (reference: perceive-core/paths.rs:3-10).

Uses XDG conventions on Linux; override with PERCEIVE_TPU_DATA_DIR.
"""

from __future__ import annotations

import os
from pathlib import Path

APP_DIRNAME = "perceive-tpu"


def data_dir() -> Path:
    env = os.environ.get("PERCEIVE_TPU_DATA_DIR")
    if env:
        p = Path(env)
    else:
        xdg = os.environ.get("XDG_DATA_HOME") or os.path.join(
            os.path.expanduser("~"), ".local", "share"
        )
        p = Path(xdg) / APP_DIRNAME
    p.mkdir(parents=True, exist_ok=True)
    return p


def database_path() -> Path:
    return data_dir() / "perceive.sqlite3"
