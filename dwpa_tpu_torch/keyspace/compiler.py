"""Pass-regex -> hashcat-mask compiler (the ``ks`` vertical's front end).

Compiles a deliberately bounded regex dialect to one or more hashcat
masks (``gen/mask.py`` syntax) with custom charsets and exact keyspace
counts, so router-default keyspaces written as regexes become
device-generated mask shards with zero dict bytes on the wire.

Supported dialect — anything else raises :class:`KeyspaceError` (loud
rejection, never a silently truncated keyspace):

- literal characters; ``\\`` escapes a metacharacter (``\\.``, ``\\{``,
  ``\\?``, ``\\\\``, ...);
- character classes ``[a-z0-9_]`` with ranges and singles; negation
  (``[^...]``) is rejected;
- the class escape ``\\d`` (= ``[0-9]``, emitted as hashcat ``?d``;
  other letter escapes are rejected);
- bounded repetition ``{n}`` / ``{m,n}`` and ``?`` (= ``{0,1}``) on the
  preceding atom; each length choice expands to its own mask;
- top-level alternation ``a|b`` — each branch compiles independently
  and the masks concatenate;
- ``^`` / ``$`` anchors at the pattern edges (accepted and dropped:
  matching is whole-password either way).

Rejected outright: unbounded ``*``/``+``, ``.``, groups, backrefs,
lookaround, negated classes, unknown escapes, non-latin1 characters,
masks longer than 63 positions (the ``device_mask_words`` limit), more
than 4 custom charsets per mask, and expansions past ``max_masks``.
A mask keyspace must be finite and exactly enumerable; anything the
dialect cannot express is an explicit error for the ks-table admin.
"""

import itertools

from ..gen.mask import CHARSETS, mask_keyspace

#: expansion bound: one pattern may compile to at most this many masks
MAX_MASKS = 64
#: hashcat mask position bound (device_mask_words packs indices in 63 lanes)
MAX_POSITIONS = 63

_CLASS_ESCAPES = {"d": "0123456789"}

#: builtin hashcat charsets by content (set-compare: class order does not
#: change the language, only the enumeration order)
_BUILTIN = {frozenset(v): "?" + k for k, v in CHARSETS.items()}


class KeyspaceError(ValueError):
    """A pass-regex outside the compilable dialect.  Carries the pattern
    and a human reason so ks-table admin tooling can surface both."""

    def __init__(self, pattern, reason):
        super().__init__(f"pass-regex {pattern!r} not compilable: {reason}")
        self.pattern = pattern
        self.reason = reason


class CompiledMask:
    """One hashcat mask: string + custom charsets + exact keyspace.

    ``custom`` maps slot keys ``"1"``-``"4"`` to latin1 *str* alphabets
    (JSON-safe for the work-unit wire format); :meth:`custom_bytes`
    yields the bytes dict ``gen.mask.parse_mask`` expects.
    """

    __slots__ = ("mask", "custom", "keyspace")

    def __init__(self, mask, custom, keyspace):
        self.mask = mask
        self.custom = custom
        self.keyspace = keyspace

    def custom_bytes(self):
        return {k: v.encode("latin1") for k, v in self.custom.items()}

    def __repr__(self):
        return f"CompiledMask({self.mask!r}, {self.custom!r}, {self.keyspace})"


class CompiledKeyspace:
    """A compiled pass-regex: the mask set plus the summed keyspace."""

    __slots__ = ("pattern", "masks", "keyspace")

    def __init__(self, pattern, masks, keyspace):
        self.pattern = pattern
        self.masks = masks
        self.keyspace = keyspace

    def __repr__(self):
        return (f"CompiledKeyspace({self.pattern!r}, "
                f"{len(self.masks)} masks, {self.keyspace})")


def _parse_class(pattern, branch, i):
    """Parse ``[...]`` starting just past ``[``; returns (alphabet, j)
    with ``j`` past the closing ``]``.  Duplicate members are dropped so
    the keyspace count stays exact."""
    n = len(branch)
    if i < n and branch[i] == "^":
        raise KeyspaceError(pattern, "negated character class [^...]")
    chars, seen = [], set()

    def add(c):
        if c not in seen:
            seen.add(c)
            chars.append(c)

    while i < n and branch[i] != "]":
        ch = branch[i]
        if ch == "\\":
            if i + 1 >= n:
                raise KeyspaceError(pattern, "dangling escape in class")
            esc = branch[i + 1]
            if esc in _CLASS_ESCAPES:
                for c in _CLASS_ESCAPES[esc]:
                    add(c)
                i += 2
                continue
            if esc.isalnum():
                raise KeyspaceError(pattern, f"unsupported escape \\{esc}")
            ch = esc
            i += 2
        else:
            i += 1
        # range a-z: '-' with a live left side and a right side before ']'
        if i + 1 < n and branch[i] == "-" and branch[i + 1] != "]":
            lo, hi = ch, branch[i + 1]
            if hi == "\\":
                raise KeyspaceError(pattern, "escape as range endpoint")
            if ord(lo) > ord(hi):
                raise KeyspaceError(pattern, f"reversed range {lo}-{hi}")
            for o in range(ord(lo), ord(hi) + 1):
                add(chr(o))
            i += 2
        else:
            add(ch)
    if i >= n:
        raise KeyspaceError(pattern, "unterminated character class")
    if not chars:
        raise KeyspaceError(pattern, "empty character class")
    return "".join(chars), i + 1


def _parse_quant(pattern, branch, i):
    """Parse ``{n}`` / ``{m,n}`` starting just past ``{``; returns
    (lo, hi, j).  A ``{`` that is not a bounded quantifier is rejected
    (literal braces must be escaped) — never silently literal."""
    j = branch.find("}", i)
    if j < 0:
        raise KeyspaceError(pattern, "unterminated {...} quantifier")
    body = branch[i:j]
    lo, sep, hi = body.partition(",")
    if not lo.isdigit() or (sep and not hi.isdigit()):
        raise KeyspaceError(pattern, f"malformed quantifier {{{body}}}")
    lo = int(lo)
    hi = int(hi) if sep else lo
    if hi < lo:
        raise KeyspaceError(pattern, f"reversed quantifier {{{body}}}")
    return lo, hi, j + 1


def _parse_branch(pattern, branch):
    """One alternation branch -> list of [alphabet, lo, hi] atoms."""
    atoms = []          # [alphabet, lo, hi]
    quantified = set()  # atom indices that already carry a quantifier
    i, n = 0, len(branch)
    while i < n:
        ch = branch[i]
        if ch == "^" and i == 0:
            i += 1
            continue
        if ch == "$" and i == n - 1:
            i += 1
            continue
        if ch in "*+":
            raise KeyspaceError(pattern,
                                f"unbounded repetition '{ch}' (keyspace "
                                "must be finite; use {m,n})")
        if ch in "()":
            raise KeyspaceError(pattern, "groups are not supported")
        if ch == ".":
            raise KeyspaceError(pattern,
                                "'.' is not supported (spell the class out)")
        if ch in "^$":
            raise KeyspaceError(pattern, f"mid-pattern anchor '{ch}'")
        if ch == "?":
            if not atoms or (len(atoms) - 1) in quantified:
                raise KeyspaceError(pattern, "'?' without a free atom")
            atoms[-1][1] = 0
            quantified.add(len(atoms) - 1)
            i += 1
            continue
        if ch == "{":
            if not atoms or (len(atoms) - 1) in quantified:
                raise KeyspaceError(pattern, "quantifier without a free atom")
            lo, hi, i = _parse_quant(pattern, branch, i + 1)
            atoms[-1][1] = lo
            atoms[-1][2] = hi
            quantified.add(len(atoms) - 1)
            continue
        if ch == "[":
            alpha, i = _parse_class(pattern, branch, i + 1)
        elif ch == "\\":
            if i + 1 >= n:
                raise KeyspaceError(pattern, "dangling escape")
            esc = branch[i + 1]
            if esc in _CLASS_ESCAPES:
                alpha = _CLASS_ESCAPES[esc]
            elif esc.isalnum():
                raise KeyspaceError(pattern, f"unsupported escape \\{esc}")
            else:
                alpha = esc
            i += 2
        else:
            alpha = ch
            i += 1
        for c in alpha:
            if ord(c) > 0xFF:
                raise KeyspaceError(pattern,
                                    f"non-latin1 character {c!r} (PSKs are "
                                    "byte strings)")
        atoms.append([alpha, 1, 1])
    return atoms


def _emit_mask(pattern, positions):
    """Per-position alphabets -> (mask string, custom charset dict)."""
    parts, custom, slots = [], {}, {}
    for alpha in positions:
        if len(alpha) == 1:
            parts.append("??" if alpha == "?" else alpha)
            continue
        tok = _BUILTIN.get(frozenset(alpha.encode("latin1")))
        if tok:
            parts.append(tok)
            continue
        key = frozenset(alpha)
        slot = slots.get(key)
        if slot is None:
            if len(slots) == 4:
                raise KeyspaceError(pattern,
                                    "more than 4 custom charsets in one mask")
            slot = str(len(slots) + 1)
            slots[key] = slot
            custom[slot] = alpha
        parts.append("?" + slot)
    return "".join(parts), custom


def _split_top(pattern):
    """Split on top-level ``|`` only: a ``|`` behind a backslash or
    inside ``[...]`` stays in its branch."""
    parts, cur, depth, i, n = [], [], 0, 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            cur += [c, pattern[i + 1]]
            i += 2
            continue
        if c == "[":
            depth = 1
        elif c == "]":
            depth = 0
        elif c == "|" and depth == 0:
            parts.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def compile_pass_regex(pattern, max_masks=MAX_MASKS):
    """Compile ``pattern`` to a :class:`CompiledKeyspace` or raise
    :class:`KeyspaceError`.

    Every mask's keyspace is the exact ``mask_keyspace`` count; the
    CompiledKeyspace total is their sum (for well-formed ks rows the
    expansions are disjoint, so the sum is the language size).
    """
    if not isinstance(pattern, str) or not pattern:
        raise KeyspaceError(pattern, "empty pattern")
    masks, seen = [], set()
    for branch in _split_top(pattern):
        if not branch.strip("^$"):
            raise KeyspaceError(pattern, "empty alternation branch")
        atoms = _parse_branch(pattern, branch)
        combos = 1
        for _, lo, hi in atoms:
            combos *= hi - lo + 1
        if len(masks) + combos > max_masks * 4:
            # cheap pre-check so a {0,60}{0,60} pattern cannot make us
            # enumerate millions of combos before the real bound trips
            raise KeyspaceError(pattern,
                                f"expands to more than {max_masks} masks")
        for lengths in itertools.product(*(range(lo, hi + 1)
                                           for _, lo, hi in atoms)):
            positions = []
            for (alpha, _, _), cnt in zip(atoms, lengths):
                positions.extend([alpha] * cnt)
            if not positions:
                raise KeyspaceError(pattern, "matches the empty string")
            if len(positions) > MAX_POSITIONS:
                raise KeyspaceError(pattern,
                                    f"mask longer than {MAX_POSITIONS} "
                                    "positions")
            mask, custom = _emit_mask(pattern, positions)
            key = (mask, tuple(sorted(custom.items())))
            if key in seen:
                continue
            seen.add(key)
            ksize = mask_keyspace(mask, {k: v.encode("latin1")
                                         for k, v in custom.items()})
            masks.append(CompiledMask(mask, custom, ksize))
            if len(masks) > max_masks:
                raise KeyspaceError(pattern,
                                    f"expands to more than {max_masks} masks")
    masks.sort(key=lambda m: (m.keyspace, m.mask))
    return CompiledKeyspace(pattern, tuple(masks),
                            sum(m.keyspace for m in masks))
