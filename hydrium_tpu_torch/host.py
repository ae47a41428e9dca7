"""The port's hold on the JAX package's native serialization plane.

hydrium_tpu.jxl.native builds build/libhydtpu.so with g++ on first use,
every process writing the same temporary file.  Processes that start
together on a checkout without build/ (test workers, several encoders)
then race: a loser loads a half-written library or finds the temporary
file gone, and its cached load error turns the native plane off for the
rest of that process.  ensure_native() builds under a file lock and
clears such a cached error, so every caller of the port gets the plane
that the first one built.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

from hydrium_tpu.jxl import native


def _stale() -> bool:
    return (not os.path.exists(native._SO_PATH)
            or os.path.getmtime(native._SO_PATH)
            < os.path.getmtime(native._SRC_PATH))


def _retry_load() -> bool:
    """native.available() after forgetting a failed earlier load."""
    if native._lib is None:
        native._load_error = None
    return native.available()


def ensure_native() -> bool:
    """Build build/libhydtpu.so if it is missing or older than its
    source, holding build/.libhydtpu.lock so that one process builds and
    the others wait; then load it.  Returns whether the native plane is
    available.  Never raises."""
    if native._lib is not None:
        return True
    try:
        build_dir = os.path.dirname(native._SO_PATH)
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".libhydtpu.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale():
                native._build()
            if _retry_load():
                return True
            # a build racing outside the lock may have left a truncated
            # library behind: rebuild it once
            native._build()
            return _retry_load()
    except (OSError, subprocess.CalledProcessError):
        # no g++, a failed build or an unwritable build/: no native plane
        return False
