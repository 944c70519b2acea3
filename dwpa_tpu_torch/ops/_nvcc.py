"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Every kernel source under ``dwpa_tpu_torch/csrc`` has a plain C interface
and is compiled for ``sm_90a`` into its own shared library under
``build/dwpa_tpu_torch/`` at the repository root, named by the source's
content hash, so an edited source never loads a stale build.  The
wrappers load the libraries with ``ctypes``.  Every library actually
compiled is reported to ``analysis.recompile.note_build`` (the client's
``dwpa_client_recompiles_total``); one already on disk is not a build.
Nothing here runs at import time, so the CPU tests import the wrappers
on a machine without ``nvcc``.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..analysis.recompile import note_build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dwpa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library_path(source: Path, build_dir=None) -> Path:
    """Where the library built from ``source`` lives (``lib<stem>_<hash>.so``
    under ``build_dir``, default ``BUILD_DIR``)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"lib{source.stem}_{digest}.so"


def build(*sources: Path, build_dir=None) -> list:
    """Compile every source whose library is not built yet, one ``nvcc``
    per source, all started together; return the libraries' paths.

    ``nvcc``'s ``-Xptxas -v`` report (registers, spills) is kept beside
    each library as ``<name>.ptxas.txt``.  Raises if a build fails.
    ``build_dir`` (default ``BUILD_DIR``) is where the libraries go.
    """
    libs = [library_path(s, build_dir) for s in sources]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    Path(build_dir or BUILD_DIR).mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, so in zip(sources, libs):
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            continue
        so.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, so)
        note_build(so.name)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs
