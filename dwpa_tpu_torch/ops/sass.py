"""Count a compiled kernel's SASS instructions, in and outside its hot loop.

:func:`sass_text` reads a shared library's machine code with
``cuobjdump -sass`` (on the machine with the CUDA toolkit); the readers
of that text run anywhere: :func:`loop_span` counts a kernel's
instructions in and outside its hot loop, :func:`loop_opcodes` gives the
loop's instruction mix, :func:`pipe_split` that mix by the pipe that
issues it, and :func:`dynamic_count` the instructions one thread issues
given its loops' trip counts.  The hot loop is the longest
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


def _backward_branches(text, kernel):
    """The instructions of ``kernel`` in a ``cuobjdump -sass`` listing
    ``text``, and the (first, last) index span of each backward branch."""
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
    spans = []
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
        spans.append((index[target], i))
    return [op for _, op in insts], spans


def _loop(text, kernel):
    """The instructions of ``kernel`` and the (first, last) index of its
    hot loop, the longest backward-branch span."""
    ops, spans = _backward_branches(text, kernel)
    if not spans:
        raise ValueError(f"no loop found in the SASS of {kernel!r}")
    return ops, max(spans, key=lambda sp: sp[1] - sp[0])


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


#: Opcode prefixes by pipe, as the SM probe's mixes read on an H100: LOP3,
#: SHF, LEA and IADD3 share one 64-lane pipe (each alone and their SHA-1
#: round mix run at 64 thread-instructions a clock an SM), IMAD and VIADD
#: issue beside it (IADD3 with IMAD.IADD, LOP3 with IMAD or VIADD run above
#: 64).  IMAD.HI issues at half the FMA pipe's rate.
PIPES = {"alu": ("LOP3", "SHF", "LEA", "IADD3"), "fma": ("IMAD", "VIADD")}


def pipe_split(opcodes):
    """``{"alu", "fma", "other"}`` counts of a :func:`loop_opcodes` counter,
    by :data:`PIPES`."""
    out = dict.fromkeys(("alu", "fma", "other"), 0)
    for op, n in opcodes.items():
        pipe = next((p for p, prefixes in PIPES.items() if op.startswith(prefixes)), "other")
        out[pipe] += n
    return out


def sass_text(so):
    """``cuobjdump -sass`` of the shared library ``so``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def _loops(spans):
    """Backward-branch spans merged into loops: one (first, last) per
    branch target, outermost and earliest first.  The self-branch that
    ends every kernel, after its last ``EXIT``, is no loop."""
    ends = {}
    for first, last in spans:
        if last > first:
            ends[first] = max(last, ends.get(first, last))
    return sorted(ends.items(), key=lambda sp: (sp[0], -sp[1]))


def dynamic_count(text, kernel, trips):
    """Thread-instructions one thread of ``kernel`` issues (NOPs left out)
    when its loops (outermost and earliest first) run ``trips[k]`` times
    each: an instruction counts once per trip of every loop around it.
    Raises, naming the loops' (first, last) instruction indices, if the
    kernel has another number of loops than ``trips`` names."""
    ops, spans = _backward_branches(text, kernel)
    loops = _loops(spans)
    if len(loops) != len(trips):
        raise ValueError(f"{kernel!r} has {len(loops)} loops {loops}, {len(trips)} trip counts")
    total = 0
    for i, op in enumerate(ops):
        if _opcode(op) == "NOP":
            continue
        n = 1
        for (first, last), trip in zip(loops, trips):
            if first <= i <= last:
                n *= trip
        total += n
    return total
