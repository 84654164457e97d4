"""Atomic artifact writes (the port's copy of `repro.ioutils`).

Within ``atomic_write`` the file object points at a temp file in the target
directory (same filesystem, so the final rename is atomic); on a clean exit
the data is flushed, fsynced and renamed over ``path`` in one
``os.replace``; on any error the temp file is removed and the previous
complete artifact, if any, survives untouched. Writing through a file object
also keeps the exact path given (a bare ``np.savez(path)`` appends ".npz"
when the suffix is missing).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path
from typing import IO, Iterator


@contextlib.contextmanager
def atomic_write(path: str | os.PathLike, mode: str = "w") -> Iterator[IO]:
    """Context manager yielding a temp-file object committed to `path`.

    ``mode`` is "w" (text) or "wb" (binary). The parent directory is created
    if missing.
    """
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write mode must be 'w' or 'wb', got {mode!r}")
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory
    )
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str | os.PathLike, text: str) -> Path:
    """Atomically replace `path` with `text`."""
    with atomic_write(path, "w") as f:
        f.write(text)
    return Path(path)
