"""Shared on-demand builder for the C++ host components.

Each `*/native/__init__.py` compiles its .cpp next to the source on
first use.  Installed packages can live in read-only site-packages, so
when the package directory is not writable the artifact goes to a
per-user cache keyed by the source path and mtime (stale entries are
simply abandoned).  Callers catch exceptions and fall back to their
NumPy/device paths when no toolchain is available.
"""

from __future__ import annotations

import hashlib
import os
import subprocess


def ensure_built(src: str, so_name: str, libs: tuple = ()) -> str:
    """Compile `src` to `so_name` beside it (preferred) or in the user
    cache; returns the shared-object path.  Raises if compilation fails.
    `libs` adds linker flags (e.g. ("-lz",)) to the direct-g++ fallback;
    the Makefile path carries its own."""
    d = os.path.dirname(os.path.abspath(src))
    so = os.path.join(d, so_name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    if os.access(d, os.W_OK):
        try:
            subprocess.run(["make", "-C", d, so_name],
                           check=True, capture_output=True)
            return so
        except Exception:
            pass
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             src, "-o", so, "-lpthread", *libs],
            check=True, capture_output=True)
        return so
    # read-only install: build into a user-writable cache
    tag = hashlib.sha1(
        f"{src}:{os.path.getmtime(src)}".encode()
    ).hexdigest()[:16]
    cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "pseudoaligner_torch",
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"{tag}-{so_name}")
    if os.path.exists(so):
        return so
    tmp = so + ".tmp"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
         src, "-o", tmp, "-lpthread", *libs],
        check=True, capture_output=True)
    os.replace(tmp, so)
    return so
