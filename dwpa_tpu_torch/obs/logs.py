"""One-shot logging config for every dwpa_tpu_torch process.

``setup_logging()`` configures the package root logger (``dwpa_tpu_torch``)
exactly once; the client loop, the server CLI, and library modules that
already log via ``logging.getLogger(__name__)`` (server/tools.py,
rules/engine.py) all inherit it — one config, every emitter.

Console format is the historical one the client printed (the bare
message), so operator muscle memory and log scrapers keep working.
``DWPA_LOG=json`` switches every line to structured JSON
(``{"ts", "level", "logger", "msg"}``) for ingestion pipelines;
``DWPA_LOG_LEVEL`` overrides the level (default INFO).
"""

import json
import logging
import os
import sys
import time

ROOT_LOGGER = "dwpa_tpu_torch"


class JsonFormatter(logging.Formatter):
    def format(self, record):
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + ".%03dZ" % (record.msecs,),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def setup_logging(level=None, stream=None, force: bool = False):
    """Configure and return the ``dwpa_tpu_torch`` logger.  Idempotent: a
    second call is a no-op unless ``force`` (tests) — so the client
    entry point, the server CLI, and embedding code can all call it
    without stacking handlers."""
    logger = logging.getLogger(ROOT_LOGGER)
    if logger.handlers and not force:
        return logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    if os.environ.get("DWPA_LOG", "").lower() == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    if level is None:
        level = os.environ.get("DWPA_LOG_LEVEL", "INFO").upper()
    logger.setLevel(level)
    # Propagation stays ON (the library convention): the bare root
    # logger has no handlers, so CLI output is emitted once by the
    # handler above, while root-attached observers — pytest's caplog,
    # an embedding app's aggregation handler — still see every record.
    return logger


def get_logger(name: str = None) -> logging.Logger:
    """A child of the package logger (``dwpa_tpu_torch.<name>``)."""
    return logging.getLogger(
        ROOT_LOGGER if not name else
        name if name.startswith(ROOT_LOGGER) else f"{ROOT_LOGGER}.{name}")
