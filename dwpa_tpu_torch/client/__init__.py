"""dwpa protocol client: fetch work, crack on the GPU, submit founds."""

from .protocol import NoNets, ServerAPI, VersionRejected  # noqa: F401
from .main import ClientConfig, TpuCrackClient  # noqa: F401
