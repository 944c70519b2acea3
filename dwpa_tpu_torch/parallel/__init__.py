"""Device selection, the single-device crack step, per-device streams
and multi-process slices."""

from .mesh import multihost_mesh, process_count, process_index  # noqa: F401
from .streams import (  # noqa: F401
    DeviceStream, StreamError, StreamExecutor, default_feed_workers,
    streams_default)
