"""Count a compiled kernel's SASS instructions, in and outside its hot loop.

:func:`sass_text` reads a shared library's machine code with
``cuobjdump -sass`` (on the machine with the CUDA toolkit); the readers
of that text run anywhere: :func:`loop_span` counts a kernel's
instructions in and outside its hot loop, :func:`loop_opcodes` gives the
loop's instruction mix.  The hot loop is the longest
backward-branch span of the kernel's code; NOPs are not counted.
Kernel bounds in ``chip_smoke.py`` and the SM probe's per-step counts are
built on these numbers.
"""

import re
import shutil
import subprocess
from collections import Counter

_FUNCTION = re.compile(r"\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"\s*(\.L_x_\d+):")
_INST = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")


def _kernel_lines(text, kernel):
    """The SASS lines of the one function whose (mangled) name contains
    ``kernel``."""
    sections, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = sections.setdefault(m.group(1), [])
        elif current is not None:
            current.append(line)
    hits = [name for name in sections if kernel in name]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} functions named like {kernel!r} in the SASS: {hits}")
    return sections[hits[0]]


def _is_branch(op):
    return any(tok == "BRA" or tok.startswith("BRA.") for tok in op.split())


def _loop(text, kernel):
    """The instructions of ``kernel`` in a ``cuobjdump -sass`` listing
    ``text``, and the (first, last) index of its hot loop."""
    insts, labels, pending = [], {}, []
    for line in _kernel_lines(text, kernel):
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INST.match(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, m.group(2).strip()))
    index = {addr: i for i, (addr, _) in enumerate(insts)}
    best = None
    for i, (_, op) in enumerate(insts):
        if not _is_branch(op):
            continue
        t = re.search(r"`\((\.L_x_\d+)\)", op)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            a = re.search(r"0x([0-9a-f]+)", op)
            target = int(a.group(1), 16) if a else None
        if target is None or target not in index or index[target] > i:
            continue
        span = (index[target], i)
        if best is None or span[1] - span[0] > best[1] - best[0]:
            best = span
    if best is None:
        raise ValueError(f"no loop found in the SASS of {kernel!r}")
    return [op for _, op in insts], best


def _opcode(op):
    toks = op.split()
    return toks[1] if toks[0].startswith("@") else toks[0]


def loop_span(text, kernel):
    """(instructions of the hot loop, instructions outside it) of
    ``kernel`` in a ``cuobjdump -sass`` listing ``text``."""
    ops, (first, last) = _loop(text, kernel)
    real = [_opcode(op) != "NOP" for op in ops]
    loop = sum(real[first: last + 1])
    return loop, sum(real) - loop


def loop_opcodes(text, kernel):
    """Counter of the opcodes in ``kernel``'s hot loop (NOPs left out)."""
    ops, (first, last) = _loop(text, kernel)
    return Counter(c for c in map(_opcode, ops[first: last + 1]) if c != "NOP")


def sass_text(so):
    """``cuobjdump -sass`` of the shared library ``so``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
