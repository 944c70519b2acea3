"""Build the port's host C++ sources with ``g++`` into shared libraries.

The host twin of ``ops/_nvcc.py``: a source (``native/pack_fast.cpp``)
is compiled with ``g++ -O2 -shared -fPIC`` into ``build/dwpa_tpu_torch/``
at the repository root, named by the source's content hash, so a first
run never writes into the package directory and an edited source never
loads a stale build.  A library actually compiled is reported to
``analysis.recompile.note_build``.  Nothing here runs at import time.
"""

import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..analysis.recompile import note_build
from ._nvcc import BUILD_DIR, library_path

GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def build(source: Path, build_dir=None) -> Path:
    """Compile ``source`` unless its library is built (under ``build_dir``,
    default ``BUILD_DIR``); return its path.  Raises ``OSError`` or
    ``subprocess.CalledProcessError`` on failure."""
    so = library_path(source, build_dir)
    if so.exists():
        return so
    gxx = shutil.which("g++") or "g++"
    Path(build_dir or BUILD_DIR).mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(source)],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    note_build(so.name)
    return so
