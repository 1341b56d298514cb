"""Size-based rotation for append-only JSONL sinks — port of
``tdfo_tpu/utils/logrotate.py``.

A full sink is closed (every record complete: the writers append whole
lines) and renamed to ``<name>.1``, replacing the previous overflow; a
fresh file continues under the original name.  A crash at any byte leaves
whole lines in both generations.  The request log is not rotated here:
``data/replay.py::RequestLog`` seals its own segments.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import IO

__all__ = ["rotate_path", "maybe_rotate_path", "maybe_rotate_file"]


def rotate_path(path: Path) -> None:
    """Atomically retire a closed, complete JSONL file to ``<name>.1``."""
    path = Path(path)
    os.replace(path, path.with_name(path.name + ".1"))


def maybe_rotate_path(path: str | Path, rotate_bytes: int) -> bool:
    """Rotate a closed-between-appends sink (the ``retries.jsonl`` shape)
    once it reaches ``rotate_bytes``.  Returns whether it rotated."""
    if not rotate_bytes:
        return False
    path = Path(path)
    try:
        if path.stat().st_size < rotate_bytes:
            return False
    except OSError:
        return False
    rotate_path(path)
    return True


def maybe_rotate_file(f: IO[str], path: str | Path, rotate_bytes: int) -> IO[str]:
    """Rotate an open append handle (the ``metrics.jsonl`` shape) once its
    write position reaches ``rotate_bytes``.  Returns the handle to keep
    writing to — the original, or a fresh one after rotation."""
    if not rotate_bytes or f.tell() < rotate_bytes:
        return f
    f.close()
    rotate_path(Path(path))
    return open(path, "a")
