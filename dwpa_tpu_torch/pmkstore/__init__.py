"""dwpa_tpu_torch.pmkstore — persistent cross-unit PBKDF2->PMK cache.

- :mod:`.store` — the crash-safe, size-capped, per-ESSID on-disk record
  store (CRC-framed 40-byte records, mmap reads, segment-rotation
  eviction); its files are byte-compatible with ``dwpa_tpu.pmkstore``'s.
- :mod:`.stage` — the producer-thread hit/miss split that feeds the
  engine's mixed-block dispatch (``M22000Engine._dispatch_mixed`` /
  ``parallel.step.mix_step``).

The client's ``--pmk-cache-dir`` / ``--pmk-cache-max-bytes`` attach one to
the engine.
"""

from .stage import EssidSplit, MixedPrep, miss_width, miss_widths, split_block
from .store import PMKStore, word_digest

__all__ = [
    "PMKStore", "word_digest",
    "MixedPrep", "EssidSplit", "split_block", "miss_width", "miss_widths",
]
