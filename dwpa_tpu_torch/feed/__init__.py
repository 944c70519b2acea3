"""dwpa_tpu_torch.feed — the pipelined candidate-feed subsystem.

Overlaps host candidate production with device compute:

- :mod:`.framing` — deterministic ``(global_offset, count)`` block
  framing (single-host and multi-host shard slicing; the resume-gate
  contract lives here), plus ``frame_packed`` — the index-backed twin
  that frames packed chunks into the same geometry with lazy
  ``PackedSlices`` preps;
- :mod:`.pipeline` — ``CandidateFeed``: bounded block queue filled by
  producer threads running the host stages (dict streaming, ``$HEX``
  decode + native packing), with backpressure, fault-with-offset
  delivery, and ``dwpa_feed_*`` telemetry;
- :mod:`.staging` — ``DeviceStager``: double-buffered H2D on a CUDA
  side stream, enqueueing block N+1's upload while block N's steps
  execute.

Consumed by ``M22000Engine.crack_blocks`` and wired through the client
(pass 1, pass 2, prewarm).  The packed-dictionary cache and its feed
source ``DictFeedSource`` are not ported yet; ``RulesFeedSource``, the
per-dict base-word framing of the rules pass, is ported without its
cache (the cold path).
"""

from .framing import Block, PackedSlices, RulesPrep, frame_blocks, \
    frame_packed, frame_rules_packed, skip_stream
from .pipeline import CandidateFeed, FeedError, RulesFeedSource
from .staging import DeviceStager

__all__ = [
    "Block", "PackedSlices", "RulesPrep", "frame_blocks", "frame_packed",
    "frame_rules_packed", "skip_stream", "CandidateFeed", "FeedError",
    "DeviceStager", "RulesFeedSource",
]
