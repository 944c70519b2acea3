"""Seeded fault schedules.

A :class:`FaultPlan` is consulted once per raw transport call and answers
"which fault, if any, hits this call?".  Decisions come from a private
``random.Random(seed)`` — given the same seed and the same call sequence,
the schedule is bit-identical, and :meth:`FaultPlan.schedule` returns the
full decision log so two runs can be compared outright.

Two scheduling modes compose:

- probabilistic: each call faults with probability ``rate``, the kind
  drawn uniformly from ``kinds``;
- forced: ``force(endpoint, kind)`` queues a fault for the next call to
  that endpoint — how soak tests guarantee "at least one timeout, one
  5xx, one truncated body, one put_work reject" without fishing for a
  lucky seed.
"""

import random

# Transport fault kinds understood by ChaosTransport:
#   drop      connection reset mid-exchange
#   timeout   socket timeout
#   truncate  response body cut in half
#   garbage   response body replaced with non-JSON bytes
#   http_4xx  HTTP 404 (classified permanent)
#   http_429  HTTP 429 + Retry-After (server admission control; transient)
#   http_5xx  HTTP 503 (classified transient)
#   slow      response delayed by ``slow_s``
#   reject    response body replaced with a non-OK refusal
FAULT_KINDS = ("drop", "timeout", "truncate", "garbage",
               "http_4xx", "http_429", "http_5xx", "slow", "reject")

# Kinds safe for blanket probabilistic injection: every one is either
# retried as transient or re-fetched by validation — a schedule of these
# never makes a correct client lose work.  http_429 is transient too but
# deliberately NOT listed: adding a kind here would shift every existing
# seeded schedule's uniform draws — 429s are injected via force() or an
# explicit kinds= override instead.
TRANSIENT_KINDS = ("drop", "timeout", "truncate", "garbage", "http_5xx",
                   "slow")


class FaultPlan:
    def __init__(self, seed: int, rate: float = 0.0, kinds=TRANSIENT_KINDS):
        self.seed = seed
        self.rate = rate
        self.kinds = tuple(kinds)
        self._rng = random.Random(seed)
        self._forced = {}  # endpoint -> [kind, ...] FIFO
        self._log = []     # (call_index, endpoint, kind-or-None)

    def force(self, endpoint: str, kind: str) -> "FaultPlan":
        """Queue ``kind`` for the next call to ``endpoint`` (FIFO when
        called repeatedly).  Chains for terse soak setup."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {kind!r}")
        self._forced.setdefault(endpoint, []).append(kind)
        return self

    def next_fault(self, endpoint: str):
        """The fault for this call (or None) — one decision per call."""
        queue = self._forced.get(endpoint)
        if queue:
            kind = queue.pop(0)
        elif self.rate and self._rng.random() < self.rate:
            kind = self.kinds[self._rng.randrange(len(self.kinds))]
        else:
            kind = None
        self._log.append((len(self._log), endpoint, kind))
        return kind

    def schedule(self) -> list:
        """The decision log so far: ``[(index, endpoint, kind), ...]``."""
        return list(self._log)

    def kinds_injected(self) -> set:
        return {kind for _, _, kind in self._log if kind is not None}
