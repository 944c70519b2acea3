"""Build sentinel: count kernel and native-library builds at runtime.

The JAX package counts XLA compile-cache misses here.  The port compiles
no XLA programs: what it builds are its kernel libraries (``ops/_nvcc.py``,
one ``nvcc`` per CUDA source) and its native host libraries
(``ops/_gxx.py``), each named by its source's content hash.  A build is a
miss of that cache — seconds of ``nvcc`` or ``g++`` inside whatever was
running — so it is what this sentinel counts, with the JAX contract:

    with watch_compiles() as rep:
        client.process_work(work)
    assert rep.count == 0, rep.names

    with no_recompiles(allowed=0, label="second unit"):
        client.process_work(work)          # raises on any build

Both build modules report each library they actually compile through
one hook, ``note_build(name)``; a library already on disk is not a
build.  Watching is process-wide, as JAX's logging handler is: a build
on any thread counts in every active report.
"""

import contextlib
import threading

_watch_lock = threading.Lock()
_active = []   # CompileReports currently watching


class RecompilationError(AssertionError):
    """A guarded region built more than its budget allows."""


class CompileReport:
    """Names of every library built inside the guarded region."""

    def __init__(self):
        self.names = []

    @property
    def count(self) -> int:
        return len(self.names)

    def __repr__(self):
        return f"CompileReport(count={self.count}, names={self.names!r})"


def note_build(name: str):
    """The build modules' hook: one library (``name``) was just compiled."""
    with _watch_lock:
        reports = list(_active)
    for rep in reports:
        rep.names.append(name)


@contextlib.contextmanager
def watch_compiles():
    """Collect-only sentinel: yields a CompileReport that accumulates the
    name of every kernel or native library built in the region."""
    report = CompileReport()
    with _watch_lock:
        _active.append(report)
    try:
        yield report
    finally:
        with _watch_lock:
            _active.remove(report)


@contextlib.contextmanager
def no_recompiles(allowed: int = 0, label: str = ""):
    """Fail-on-exit sentinel: raises RecompilationError when the region
    built more than ``allowed`` libraries.

    ``allowed`` budgets intentional one-time builds (the first use of a
    kernel on a fresh checkout); a steady-state region guards with the
    default 0.
    """
    with watch_compiles() as report:
        yield report
    if report.count > allowed:
        where = f" in {label}" if label else ""
        raise RecompilationError(
            f"{report.count} library build(s){where} where <= {allowed} "
            f"allowed — a kernel or native source was rebuilt on the hot "
            f"path: {report.names}")
