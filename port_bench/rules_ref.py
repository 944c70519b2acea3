"""A plain interpreter of the hashcat rule functions that the cells' rule
files use, for planting PSKs (``rule(word)``) in a rules cell.

It imports nothing of the program.  A rule with a function it does not
know raises, so a rule file that needs more fails in set-up, not in the
comparison.  Positions are 0-9 then A-Z (10-35), as hashcat reads them.
"""

POS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
ARITY = {":": 0, "l": 0, "u": 0, "c": 0, "C": 0, "t": 0, "r": 0, "d": 0, "f": 0,
         "{": 0, "}": 0, "[": 0, "]": 0, "q": 0, "T": 1, "$": 1, "^": 1, "'": 1,
         "z": 1, "Z": 1, "s": 2}


def _lower(w):
    return bytes(b + 32 if 65 <= b <= 90 else b for b in w)


def _upper(w):
    return bytes(b - 32 if 97 <= b <= 122 else b for b in w)


def _toggle(b):
    return b ^ 32 if 65 <= b <= 90 or 97 <= b <= 122 else b


def parse(rule: str) -> list:
    """``rule`` (one line, functions separated by spaces or not) -> [(op, args)]."""
    ops, i = [], 0
    while i < len(rule):
        op = rule[i]
        if op == " ":
            i += 1
            continue
        if op not in ARITY:
            raise ValueError(f"rule function {op!r} of {rule!r} is not interpreted")
        n = ARITY[op]
        args = rule[i + 1:i + 1 + n]
        if len(args) != n:
            raise ValueError(f"rule {rule!r} ends inside {op!r}")
        ops.append((op, args))
        i += 1 + n
    return ops


def apply(rule: str, word: bytes) -> bytes:
    w = word
    for op, a in parse(rule):
        if op == "l":
            w = _lower(w)
        elif op == "u":
            w = _upper(w)
        elif op == "c":
            w = _upper(w[:1]) + _lower(w[1:])
        elif op == "C":
            w = _lower(w[:1]) + _upper(w[1:])
        elif op == "t":
            w = bytes(_toggle(b) for b in w)
        elif op == "T":
            p = POS.index(a)
            if p < len(w):
                w = w[:p] + bytes([_toggle(w[p])]) + w[p + 1:]
        elif op == "r":
            w = w[::-1]
        elif op == "d":
            w = w + w
        elif op == "f":
            w = w + w[::-1]
        elif op == "{":
            w = w[1:] + w[:1]
        elif op == "}":
            w = w[-1:] + w[:-1]
        elif op == "[":
            w = w[1:]
        elif op == "]":
            w = w[:-1]
        elif op == "q":
            w = bytes(b for b in w for _ in (0, 1))
        elif op == "$":
            w = w + a.encode("latin1")
        elif op == "^":
            w = a.encode("latin1") + w
        elif op == "'":
            w = w[:POS.index(a)]
        elif op == "z":
            w = w[:1] * POS.index(a) + w
        elif op == "Z":
            w = w + w[-1:] * POS.index(a)
        elif op == "s":
            w = w.replace(a[0].encode("latin1"), a[1].encode("latin1"))
    return w


def rule_lines(text: str) -> list:
    """The rules of a rule file: its lines without comments and blanks."""
    return [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
