"""Desktop launcher installation: port of perceive_tpu/cli/desktop.py.

The reference ships perceive as a Tauri desktop application: a native
window hosting a search page that talks to the in-process engine over three
RPCs.  The port's equivalent is ``python -m perceive_tpu_torch.cli app``
(serve + the embedded web UI, perceive_tpu_torch/serve.py); this module
makes it installable: it writes a freedesktop.org ``.desktop`` entry
(Linux) or a clickable ``.command`` launcher (macOS) that starts the app and
opens the UI.  The entry has a name of its own, so that it never overwrites
the JAX package's launcher.
"""

from __future__ import annotations

import os
import shlex
import stat
import sys
from pathlib import Path

_DESKTOP_ENTRY = """[Desktop Entry]
Type=Application
Name=Perceive (PyTorch + CUDA)
Comment=Semantic search for your life, on an NVIDIA GPU
Exec={exec_line}
Terminal=false
Categories=Utility;Office;
Keywords=search;semantic;index;
"""

ENTRY_NAME = "perceive-tpu-torch.desktop"
COMMAND_NAME = "Perceive Torch.command"


def _exec_quote(arg: str) -> str:
    """Quote one Exec argument per the Desktop Entry Spec (double quotes +
    backslash escaping: POSIX single quotes are NOT valid there and
    spec-compliant launchers misparse them)."""
    if not any(c in arg for c in " \t\n\"'\\><~|&;$*?#()`"):
        return arg
    escaped = arg.replace("\\", "\\\\").replace('"', '\\"').replace("`", "\\`").replace("$", "\\$")
    return f'"{escaped}"'


def _launch_command(quote=_exec_quote) -> str:
    """The command the launcher runs: this interpreter + the CLI app mode."""
    return f"{quote(sys.executable)} -m perceive_tpu_torch.cli app"


def install_desktop_entry(base_dir: str | None = None) -> str:
    """Write the launcher and return its path.

    Linux (XDG): ``~/.local/share/applications/perceive-tpu-torch.desktop``.
    macOS: ``~/Applications/Perceive Torch.command`` (double-clickable).
    ``base_dir`` overrides the destination root (tests)."""
    if sys.platform == "darwin" and base_dir is None:
        dest = Path.home() / "Applications"
        dest.mkdir(parents=True, exist_ok=True)
        path = dest / COMMAND_NAME
        # a .command runs through sh: POSIX quoting is right here
        path.write_text(f"#!/bin/sh\nexec {_launch_command(shlex.quote)}\n")
        path.chmod(path.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
        return str(path)
    root = Path(base_dir) if base_dir is not None else (
        Path(os.environ.get("XDG_DATA_HOME") or Path.home() / ".local" / "share")
    )
    dest = root / "applications"
    dest.mkdir(parents=True, exist_ok=True)
    path = dest / ENTRY_NAME
    path.write_text(_DESKTOP_ENTRY.format(exec_line=_launch_command()))
    path.chmod(0o755)
    return str(path)
