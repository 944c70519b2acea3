"""Runtime sentinels of the port (the repo's static analyser is
``dwpa_tpu.analysis``, which walks this package too)."""

from .recompile import (  # noqa: F401
    CompileReport, RecompilationError, no_recompiles, note_build,
    watch_compiles)
