"""Smart keyspace: the ``ks`` vertical.

The reference shipped an ``ks`` table mapping ssid-regex -> pass-regex
and never wired it (SURVEY §2.6, TODO:3).  This package makes it real:

- :mod:`.compiler` turns a bounded pass-regex dialect into one or more
  hashcat masks with custom charsets and exact keyspace counts;
- :mod:`.schedule` holds the server-side helpers: the compiled-mask
  cache keyed by pass_regex, ssid-regex matching, shard-coverage math
  over the ``n2m`` table, and the keyspace progress totals exposed by
  maintenance stats and ``observe_metrics``.

Mask shards are the one work-unit species that ships zero candidate
bytes on the wire: the client regenerates the range on device from
``(mask, custom, skip, limit)`` alone (gen/mask.py).
"""

from .compiler import (CompiledKeyspace, CompiledMask, KeyspaceError,
                       compile_pass_regex)
from .schedule import (MaskCache, ks_matches, mask_keyspace_totals,
                       next_uncovered)

__all__ = [
    "CompiledKeyspace", "CompiledMask", "KeyspaceError",
    "compile_pass_regex", "MaskCache", "ks_matches",
    "mask_keyspace_totals", "next_uncovered",
]
