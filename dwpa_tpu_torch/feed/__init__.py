"""dwpa_tpu_torch.feed — the pipelined candidate-feed subsystem.

Overlaps host candidate production with device compute:

- :mod:`.framing` — deterministic ``(global_offset, count)`` block
  framing (single-host and multi-host shard slicing; the resume-gate
  contract lives here), plus ``frame_packed`` — the index-backed twin
  that frames packed chunks into the same geometry with lazy
  ``PackedSlices`` preps, and ``frame_spans``, which frames a cold
  dict's line spans into the same geometry with lazy ``PackedSpans``
  preps;
- :mod:`.pipeline` — ``CandidateFeed``: bounded block queue filled by
  producer threads running the host stages (dict streaming, ``$HEX``
  decode + native packing), with backpressure, fault-with-offset
  delivery, and ``dwpa_feed_*`` telemetry; and ``DictFeedSource`` /
  ``RulesFeedSource`` — the warm/cold dict adapters for
  ``CandidateFeed(frames=...)`` (candidate blocks for pass 2; compact
  base-word blocks for the on-device rule-expansion pass 2);
- :mod:`.dictcache` — ``DictCache``: the persistent packed-dictionary
  cache (CRC-framed chunks keyed by dhash, O(1) ``(offset, count)``
  seek, byte-capped LRU eviction) the warm path serves from — two
  species per dict: ``.dcache`` (decoded candidate rows) and
  ``.rbase`` (rule-expansion base blocks, split + pack memoized);
- :mod:`.staging` — ``DeviceStager``: double-buffered H2D on a CUDA
  side stream, enqueueing block N+1's upload while block N's steps
  execute.

Consumed by ``M22000Engine.crack_blocks`` / ``crack_rules_blocks`` and
wired through the client (pass 1, both pass-2 paths, prewarm).
"""

from .dictcache import DictCache
from .framing import Block, PackedSlices, RulesPrep, frame_blocks, \
    frame_packed, frame_rules_packed, frame_spans, skip_stream
from .pipeline import CandidateFeed, DictFeedSource, FeedError, \
    RulesFeedSource
from .staging import DeviceStager

__all__ = [
    "Block", "PackedSlices", "RulesPrep", "frame_blocks", "frame_packed",
    "frame_rules_packed", "frame_spans", "skip_stream", "CandidateFeed",
    "DictFeedSource", "FeedError", "RulesFeedSource", "DeviceStager",
    "DictCache",
]
