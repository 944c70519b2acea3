"""Hashcat rule-language interpreter (host side).

The reference distributes per-dictionary hashcat rule strings from the
server (stored in the dicts table, db/wpa.sql:48; merged and base64'd into
the work unit at web/content/get_work.php:84-92) and the client expands
wordlists with them (``hashcat --stdout -r``, help_crack/help_crack.py:508,
575).  This module interprets the rule language directly so the client
needs no hashcat binary: rules expand candidates on the host, the device
sees only fixed-shape packed batches.  It is a copy of
``dwpa_tpu/rules/engine.py``; ``rules/device.py`` holds the torch
interpreter of the same language.

Covers every function family used by the reference's bestWPA.rule (noop,
case ops, toggles, reverse/rotate, append/prepend, truncate/delete,
insert/overwrite, substitute/purge, duplication) plus the rest of the
standard single-word function set, and the reject filters (``<``, ``>``,
``_``, ``!``, ``/``, ``(``, ``)``, ``=``, ``%``).  Memory/positional ops
that hashcat itself marks unsupported in fast-kernel mode are rejected at
parse time so bad server rules fail loudly, mirroring hashcat's behavior
of skipping invalid lines with a warning.

Semantics follow the public rule-language contract (word length cap 256;
positions encoded 0-9 then A-Z = 10..35; out-of-range positional ops leave
the word unchanged — hashcat "rule position exceeds word length" no-ops).
"""

from ..obs import get_logger

# child of the package logger: one setup_logging() config (obs/logs.py)
# covers the pool-guard warning below alongside every other emitter
_log = get_logger(__name__)

MAX_WORD = 256

# positions/counts: 0-9, A-Z (10..35)
_POS = {**{chr(48 + i): i for i in range(10)}, **{chr(65 + i): 10 + i for i in range(26)}}


class RuleError(ValueError):
    """Malformed or unsupported rule text."""


def _pos(ch: str) -> int:
    if ch not in _POS:
        raise RuleError(f"bad position char {ch!r}")
    return _POS[ch]


# op -> number of argument characters
_ARITY = {
    ":": 0, "l": 0, "u": 0, "c": 0, "C": 0, "t": 0, "r": 0, "d": 0, "f": 0,
    "{": 0, "}": 0, "[": 0, "]": 0, "q": 0, "k": 0, "K": 0, "E": 0,
    "T": 1, "p": 1, "D": 1, "'": 1, "z": 1, "Z": 1, "@": 1, "$": 1, "^": 1,
    "L": 1, "R": 1, "+": 1, "-": 1, ".": 1, ",": 1, "y": 1, "Y": 1, "e": 1,
    "s": 2, "x": 2, "O": 2, "i": 2, "o": 2, "*": 2,
    # reject filters
    "<": 1, ">": 1, "_": 1, "!": 1, "/": 1, "(": 1, ")": 1, "=": 2, "%": 2,
}


class Rule:
    """One parsed rule line: a sequence of (op, args) steps."""

    __slots__ = ("steps", "text")

    def __init__(self, steps, text):
        self.steps = steps
        self.text = text

    def __repr__(self):
        return f"Rule({self.text!r})"

    def apply(self, word: bytes):
        """Mangle ``word``; returns the new word or None (rejected)."""
        w = bytearray(word)
        for op, args in self.steps:
            w = _STEP[op](w, args)
            if w is None or len(w) > MAX_WORD:
                return None
        return bytes(w)


def parse_rule(text: str) -> Rule:
    """Parse one rule line (space-separated or contiguous functions)."""
    steps = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in " \t":
            i += 1
            continue
        if ch not in _ARITY:
            raise RuleError(f"unsupported rule function {ch!r} in {text!r}")
        k = _ARITY[ch]
        args = text[i + 1 : i + 1 + k]
        if len(args) != k:
            raise RuleError(f"truncated args for {ch!r} in {text!r}")
        steps.append((ch, args))
        i += 1 + k
    return Rule(steps, text)


def parse_rules(lines, on_error: str = "skip"):
    """Parse many rule lines; '#' comments and blanks ignored.

    ``on_error``: "skip" drops bad lines (hashcat's behavior), "raise"
    propagates RuleError.
    """
    out = []
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", "replace")
        line = line.rstrip("\r\n")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        try:
            out.append(parse_rule(line))
        except RuleError:
            if on_error == "raise":
                raise
    return out


def apply_rules(rules, words, workers: int = 0, force_pool: bool = False):
    """Expand: yield every (rule, word) mangling, skipping rejects.

    Order matches hashcat --stdout: for each word, each rule in file
    order — with or without ``workers``, so resume skip-by-count and
    differential tests see one canonical stream.

    ``workers > 1`` fans the expansion over a process pool in
    order-preserving chunks: single-process expansion sustains ~0.8M
    cand/s on a small host (SURVEY §7.3.3 "keeping the device fed"),
    below what a fast device consumes; the pool scales the host
    side roughly linearly until packing/H2D dominates — PROVIDED the
    host has cores to spare.  On a host with fewer than ``workers + 1``
    cores the pool contends with the feeding process and measures
    *slower* than serial (2-core container: 769k pooled vs 995k serial,
    BENCH_r03 host_feed), so ``--rule-workers`` is auto-ignored there
    with a warning; ``force_pool`` overrides the guard (benchmarks use
    it to keep tracking the true pooled rate).
    """
    if workers and workers > 1:
        ncpu = _usable_cpus()
        if force_pool or ncpu >= workers + 1:
            yield from _apply_rules_pooled(rules, words, workers)
            return
        if workers not in _POOL_GUARD_WARNED:
            # once per (process, worker count): the condition can't
            # change at runtime and a client hits this per dict stream
            _POOL_GUARD_WARNED.add(workers)
            _log.warning(
                "rule-expansion pool disabled: %d workers need %d cores, host "
                "has %d (pooled expansion measures slower than serial when "
                "the pool contends with the feed process)",
                workers, workers + 1, ncpu,
            )
    for word in words:
        for rule in rules:
            w = rule.apply(word)
            if w is not None:
                yield w


_WORKER_RULES = {}  # worker-side: rules-key -> parsed [Rule]
_POOLS = {}         # parent-side: worker count -> live Pool (reused)
_POOL_GUARD_WARNED = set()  # worker counts already warned about


def _usable_cpus() -> int:
    """CPUs this process may actually run on — sched_getaffinity sees
    cgroup/cpuset pins that os.cpu_count() (whole-machine) does not,
    and a 2-core-pinned container on a 64-core host is exactly where
    the pool guard must trip."""
    import os

    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


def _pool_expand(args):
    texts, chunk = args
    # texts ride along with every chunk (~1 KB) so the pool can be
    # reused across different rule sets; each worker parses a given set
    # once and caches it, keyed by the texts tuple itself (a hash() key
    # could collide across rulesets and silently mangle candidates).
    rules = _WORKER_RULES.get(texts)
    if rules is None:
        rules = _WORKER_RULES.setdefault(texts, [parse_rule(t) for t in texts])
    out = []
    for word in chunk:
        for rule in rules:
            w = rule.apply(word)
            if w is not None:
                out.append(w)
    return out


def _get_pool(workers: int):
    """One long-lived pool per worker count, shared by every
    apply_rules call in the process — a work unit streams up to ~17
    dictionaries and must not pay interpreter spawn for each."""
    pool = _POOLS.get(workers)
    if pool is None:
        import atexit
        import multiprocessing

        # spawn, not fork: the calling client runs with torch's and the
        # feed's threads live, and forking a threaded process can deadlock.
        # Spawn imposes the standard multiprocessing contract — the
        # caller's __main__ must be import-safe (true for ``python -m
        # dwpa_tpu_torch.client``).
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(workers)
        _POOLS[workers] = pool
        atexit.register(pool.terminate)
    return pool


def _apply_rules_pooled(rules, words, workers, chunk_words: int = 2048):
    import collections
    import itertools

    texts = tuple(r.text for r in rules)
    it = iter(words)
    chunks = iter(lambda: list(itertools.islice(it, chunk_words)), [])
    pool = _get_pool(workers)
    # Bounded in-flight window: submit at most workers+2 chunks ahead of
    # the consumer, so a slow downstream (the device feed) applies
    # backpressure instead of the expanded keyspace piling up in RAM
    # (imap's result cache is unbounded).
    pending = collections.deque()
    for chunk in chunks:
        pending.append(pool.apply_async(_pool_expand, ((texts, chunk),)))
        if len(pending) > workers + 2:
            yield from pending.popleft().get()
    while pending:
        yield from pending.popleft().get()


# ---------------------------------------------------------------------------
# Step implementations.  Each takes (bytearray, argstring) -> bytearray|None.
# ---------------------------------------------------------------------------


def _tog(b: int) -> int:
    if 97 <= b <= 122:
        return b - 32
    if 65 <= b <= 90:
        return b + 32
    return b


def _noop(w, a):
    return w


def _lower(w, a):
    return bytearray(bytes(w).lower())


def _upper(w, a):
    return bytearray(bytes(w).upper())


def _capitalize(w, a):
    return bytearray(bytes(w[:1]).upper() + bytes(w[1:]).lower())


def _inv_capitalize(w, a):
    return bytearray(bytes(w[:1]).lower() + bytes(w[1:]).upper())


def _toggle_all(w, a):
    return bytearray(_tog(b) for b in w)


def _toggle_at(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] = _tog(w[p])
    return w


def _reverse(w, a):
    w.reverse()
    return w


def _duplicate(w, a):
    return w + w


def _repeat_n(w, a):
    return w * (_pos(a[0]) + 1)


def _reflect(w, a):
    return w + bytearray(reversed(w))


def _rotl(w, a):
    return w[1:] + w[:1]


def _rotr(w, a):
    return w[-1:] + w[:-1]


def _del_first(w, a):
    return w[1:]


def _del_last(w, a):
    return w[:-1]


def _del_at(w, a):
    p = _pos(a[0])
    if p < len(w):
        del w[p]
    return w


def _extract(w, a):
    p, m = _pos(a[0]), _pos(a[1])
    if p + m > len(w):
        return w
    return w[p : p + m]


def _omit(w, a):
    p, m = _pos(a[0]), _pos(a[1])
    if p + m > len(w):
        return w
    return w[:p] + w[p + m :]


def _insert(w, a):
    p = _pos(a[0])
    if p > len(w):
        return w
    return w[:p] + bytearray(a[1].encode("latin1")) + w[p:]


def _overwrite(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] = a[1].encode("latin1")[0]
    return w


def _truncate_at(w, a):
    return w[: _pos(a[0])]


def _append(w, a):
    return w + bytearray(a.encode("latin1"))


def _prepend(w, a):
    return bytearray(a.encode("latin1")) + w


def _substitute(w, a):
    x, y = a[0].encode("latin1")[0], a[1].encode("latin1")[0]
    return bytearray(y if b == x else b for b in w)


def _purge(w, a):
    x = a.encode("latin1")[0]
    return bytearray(b for b in w if b != x)


def _dup_first(w, a):
    return w[:1] * _pos(a[0]) + w


def _dup_last(w, a):
    return w + w[-1:] * _pos(a[0])


def _dup_all(w, a):
    out = bytearray()
    for b in w:
        out += bytes((b, b))
    return out


def _swap_front(w, a):
    if len(w) >= 2:
        w[0], w[1] = w[1], w[0]
    return w


def _swap_back(w, a):
    if len(w) >= 2:
        w[-1], w[-2] = w[-2], w[-1]
    return w


def _swap_at(w, a):
    p, m = _pos(a[0]), _pos(a[1])
    if p < len(w) and m < len(w):
        w[p], w[m] = w[m], w[p]
    return w


def _shift_left(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] = (w[p] << 1) & 0xFF
    return w


def _shift_right(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] >>= 1
    return w


def _incr(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] = (w[p] + 1) & 0xFF
    return w


def _decr(w, a):
    p = _pos(a[0])
    if p < len(w):
        w[p] = (w[p] - 1) & 0xFF
    return w


def _replace_next(w, a):
    p = _pos(a[0])
    if p + 1 < len(w):
        w[p] = w[p + 1]
    return w


def _replace_prior(w, a):
    p = _pos(a[0])
    if 0 < p < len(w):
        w[p] = w[p - 1]
    return w


def _dup_block_front(w, a):
    p = _pos(a[0])
    if p > len(w):
        return w
    return w[:p] + w


def _dup_block_back(w, a):
    p = _pos(a[0])
    if p > len(w):
        return w
    return w + w[len(w) - p :]


def _title(w, a):
    sep = a.encode("latin1")[0] if a else 0x20
    out = bytearray(bytes(w).lower())
    up = True
    for i, b in enumerate(out):
        if up:
            out[i] = _tog(b) if 97 <= b <= 122 else b
        up = b == sep
    return out


def _rej_less(w, a):
    return w if len(w) < _pos(a[0]) else None


def _rej_greater(w, a):
    return w if len(w) > _pos(a[0]) else None


def _rej_len_eq(w, a):
    return w if len(w) == _pos(a[0]) else None


def _rej_contain(w, a):
    return None if a.encode("latin1")[0] in w else w


def _rej_not_contain(w, a):
    return w if a.encode("latin1")[0] in w else None


def _rej_first(w, a):
    return w if w[:1] == a.encode("latin1") else None


def _rej_last(w, a):
    return w if w[-1:] == a.encode("latin1") else None


def _rej_at(w, a):
    p = _pos(a[0])
    return w if p < len(w) and w[p] == a[1].encode("latin1")[0] else None


def _rej_count(w, a):
    n, x = _pos(a[0]), a[1].encode("latin1")[0]
    return w if bytes(w).count(bytes((x,))) >= n else None


_STEP = {
    ":": _noop, "l": _lower, "u": _upper, "c": _capitalize, "C": _inv_capitalize,
    "t": _toggle_all, "T": _toggle_at, "r": _reverse, "d": _duplicate,
    "p": _repeat_n, "f": _reflect, "{": _rotl, "}": _rotr, "[": _del_first,
    "]": _del_last, "D": _del_at, "x": _extract, "O": _omit, "i": _insert,
    "o": _overwrite, "'": _truncate_at, "$": _append, "^": _prepend,
    "s": _substitute, "@": _purge, "z": _dup_first, "Z": _dup_last,
    "q": _dup_all, "k": _swap_front, "K": _swap_back, "*": _swap_at,
    "L": _shift_left, "R": _shift_right, "+": _incr, "-": _decr,
    ".": _replace_next, ",": _replace_prior, "y": _dup_block_front,
    "Y": _dup_block_back, "e": _title, "E": lambda w, a: _title(w, " "),
    "<": _rej_less, ">": _rej_greater, "=": _rej_at, "_": _rej_len_eq,
    "!": _rej_contain, "/": _rej_not_contain, "(": _rej_first, ")": _rej_last,
    "%": _rej_count,
}
