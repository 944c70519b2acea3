"""K3, the crack step's verify kernels: build, bind and launch.

The kernels (``csrc/verify.cu``) replace no Pallas kernel: they do on the
card what XLA's compiled ``verify_step`` does in the JAX package, the
PMKID, keyver 1/2 and keyver 3 matches of ``dwpa_tpu/models/m22000.py``
(``_pmkid_impl``, ``eapol_match``, ``eapol_cmac_match``).  The source's
note says what bounds them and how.  The library is compiled at first use
by ``ops/_nvcc.py`` and loaded with ``ctypes``; nothing here runs at
import time, so the CPU tests import this module on a machine without
``nvcc``, and the input checks (``check_*``) run there too.

The plain versions are ``ops/verify.py``; ``models/m22000`` routes a CPU
``pmk`` to them and a CUDA one here.  Each wrapper takes its constants
with one leading net axis ``N`` (or none, for a single net: the wrapper
adds and removes a net axis of 1), launches on the current stream and
does not synchronise.  The kernels read the part's derived constants
(``ops/verify_prep.py``) in place of the constants they are built from:
the caller builds them once (a crack step when it is built) and passes
them as ``prep``, which every wrapper requires.
"""

import collections
import ctypes
import functools
import threading

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "verify.cu"

#: Kernel launches in this process by entry ("pmkid", "eapol", "cmac"),
#: counted under a lock: device streams launch from several threads.
LAUNCHES = collections.Counter()

#: Nets one launch takes (the grid's y dimension for eapol and cmac).
MAX_NETS = 65535

#: Threads a block of the PMKID kernel (``kBlock`` in ``verify.cu``).
PMKID_BLOCK = 128
#: Blocks an SM gets from the columns alone at or above which a PMKID
#: thread takes all of a part's nets; below it the nets are split into
#: groups over the grid's y dimension until the card has that many.
PMKID_BLOCKS_PER_SM = 4

_lib = None
_lib_lock = threading.Lock()  # first use may come from any thread
_count_lock = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pmk, B, sched, target, N, per, out, stream
    "verify_pmkid_launch": [_P, _I, _P, _P, _I, _I, _P, _P],
    # pmk, B, V, order, prf_sched, E, eapol_sched, target, N, keyver, out, stream
    "verify_eapol_launch": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    # pmk, B, V, prf_sched, F, cmac_words, last_complete, N, out, stream
    "verify_cmac_launch": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _P],
}


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_operands(pmk, *named, aligned=False):
    """``pmk`` int32[8, B]; each ``(name, tensor, shape)`` an int32 tensor
    of exactly ``shape`` on ``pmk``'s device; every operand contiguous,
    and with ``aligned`` at a 16-byte boundary (the kernels read derived
    schedules and words 16 bytes at a time)."""
    if pmk.dtype != torch.int32 or pmk.dim() != 2 or pmk.shape[0] != 8:
        raise ValueError(f"pmk must be int32[8, B], got {pmk.dtype}{list(pmk.shape)}")
    if not pmk.is_contiguous():
        raise ValueError("pmk must be contiguous")
    for name, t, shape in named:
        if t.dtype != torch.int32 or t.device != pmk.device:
            raise ValueError(f"{name} must be an int32 tensor on {pmk.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte boundary")


def _nets(t, tail):
    """N of a constant ``[N, *tail]`` (``tail`` its trailing rank)."""
    if t.dim() != tail + 1:
        raise ValueError(f"expected one leading net axis, got shape {list(t.shape)}")
    if not 1 <= t.shape[0] <= MAX_NETS:
        raise ValueError(f"{t.shape[0]} nets in one launch (1..{MAX_NETS})")
    return t.shape[0]


def _block_rows(blocks):
    """The block count of ``[N, rows, 16]`` constants (-1 for another rank,
    which the shape check then refuses)."""
    return blocks.shape[1] if blocks.dim() == 3 else -1


def check_pmkid(pmk, msg_block, target, prep=None):
    """Validate K3.pmkid's operands: ``msg_block`` int32[N, 16],
    ``target`` int32[N, 4]; and ``prep``, if given, the derived
    ``(sched int32[N, 80],)``.  -> N."""
    n = _nets(msg_block, 1)
    _check_operands(pmk, ("msg_block", msg_block, (n, 16)), ("target", target, (n, 4)))
    if prep is not None:
        (sched,) = _prep_arity(prep, ("sched",))
        _check_operands(pmk, ("sched", sched, (n, 80)), aligned=True)
    return n


def _prep_arity(prep, names):
    if len(prep) != len(names):
        raise ValueError(f"expected derived constants ({', '.join(names)}), got {len(prep)}")
    return prep


def check_eapol(pmk, prf_blocks, eapol_blocks, target, keyver, prep=None):
    """Validate K3.eapol's operands: ``prf_blocks`` int32[N, V, 2, 16],
    ``eapol_blocks`` int32[N, E, 16], ``target`` int32[N, 4], keyver 1
    or 2; and ``prep``, if given, the derived ``(order int32[N, V],
    prf_sched int32[N, V, 2, 80], eapol_sched int32[N, E, 80]`` for
    keyver 2, ``[N, E, 64]`` for keyver 1``)``.  -> (N, V, E)."""
    if keyver not in (1, 2):
        raise ValueError(f"keyver must be 1 or 2, got {keyver}")
    n = _nets(prf_blocks, 3)
    v, e = prf_blocks.shape[1], _block_rows(eapol_blocks)
    _check_operands(pmk, ("prf_blocks", prf_blocks, (n, v, 2, 16)),
                    ("eapol_blocks", eapol_blocks, (n, e, 16)), ("target", target, (n, 4)))
    if prep is not None:
        order, prf_sched, eapol_sched = _prep_arity(prep, ("order", "prf_sched", "eapol_sched"))
        _check_operands(pmk, ("order", order, (n, v)), ("prf_sched", prf_sched, (n, v, 2, 80)),
                        ("eapol_sched", eapol_sched, (n, e, 64 if keyver == 1 else 80)),
                        aligned=True)
    return n, v, e


def check_cmac(pmk, prf_blocks, cmac_full, cmac_last, target, prep=None):
    """Validate K3.cmac's operands: ``prf_blocks`` int32[N, V, 2, 16],
    ``cmac_full`` int32[N, F, 16] (F may be 0), ``cmac_last`` and
    ``target`` int32[N, 16] byte values; and ``prep``, if given, the
    derived ``(prf_sched int32[N, 1 + V, 64], cmac_words int32[N, F + 2,
    4])``.  -> (N, V, F)."""
    n = _nets(prf_blocks, 3)
    v, f = prf_blocks.shape[1], _block_rows(cmac_full)
    _check_operands(pmk, ("prf_blocks", prf_blocks, (n, v, 2, 16)),
                    ("cmac_full", cmac_full, (n, f, 16)), ("cmac_last", cmac_last, (n, 16)),
                    ("target", target, (n, 16)))
    if prep is not None:
        prf_sched, words = _prep_arity(prep, ("prf_sched", "cmac_words"))
        _check_operands(pmk, ("prf_sched", prf_sched, (n, 1 + v, 64)),
                        ("cmac_words", words, (n, f + 2, 4)), aligned=True)
    return n, v, f


def pmkid_nets_per_thread(b, n, sms):
    """The nets one PMKID thread takes at ``b`` columns and ``n`` nets on
    a card of ``sms`` SMs: all ``n`` when the columns alone give every SM
    ``PMKID_BLOCKS_PER_SM`` blocks (every batch of 131072 words), else as
    few as make up that many blocks with the nets' groups, down to one."""
    blocks = max(1, -(-b // PMKID_BLOCK))
    groups = min(n, -(-PMKID_BLOCKS_PER_SM * sms // blocks))
    return -(-n // max(1, groups))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _need_card(entry, pmk):
    if not pmk.is_cuda:
        raise ValueError(f"K3.{entry} needs CUDA tensors")


def _launch(entry, name, pmk, out, *args):
    """Run launch function ``name`` on ``pmk``'s device and current
    stream with ``args`` (pointers as ints) and count it under ``entry``."""
    _need_card(entry, pmk)
    fn = getattr(_library(), name)
    with torch.cuda.device(pmk.device):
        stream = torch.cuda.current_stream(pmk.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"K3.{entry} kernel launch failed: cudaError {err}")
    if pmk.shape[1] and out.numel():
        with _count_lock:
            LAUNCHES[entry] += 1
    return out


def pmkid_match_cuda(pmk, msg_block, target, prep=(), nets_per_thread=None):
    """PMKID match on the GPU -> bool[N, B] (bool[B] for a single net's
    ``msg_block`` int32[16], ``target`` int32[4]); bit-identical to
    ``ops/verify.pmkid_plain``.  ``prep``: the part's derived constants
    (``verify_prep.derive``, with their net axis); a call without them
    raises.  ``nets_per_thread``: by default :func:`pmkid_nets_per_thread`
    on ``pmk``'s card."""
    _need_card("pmkid", pmk)
    if msg_block.dim() == 1:
        return pmkid_match_cuda(pmk, msg_block[None], target[None], prep, nets_per_thread)[0]
    prep = tuple(prep)
    n = check_pmkid(pmk, msg_block, target, prep)
    (sched,) = prep
    b = pmk.shape[1]
    per = nets_per_thread
    if per is None:
        per = pmkid_nets_per_thread(b, n, _sm_count(pmk.device.index))
    if not 1 <= per <= n:
        raise ValueError(f"nets_per_thread must be in 1..{n}, got {per}")
    out = torch.empty((n, b), dtype=torch.bool, device=pmk.device)
    return _launch("pmkid", "verify_pmkid_launch", pmk, out, pmk.data_ptr(), b,
                   sched.data_ptr(), target.data_ptr(), n, per, out.data_ptr())


def eapol_match_cuda(pmk, prf_blocks, eapol_blocks, target, keyver, prep=()):
    """Keyver 1/2 MIC match over every variant on the GPU -> bool[N, V, B]
    (bool[V, B] for a single net's constants); bit-identical to
    ``ops/verify.eapol_match_plain``.  ``prep``: the part's derived
    constants (``verify_prep.derive``, with their net axis); a call
    without them raises."""
    _need_card("eapol", pmk)
    if prf_blocks.dim() == 3:
        return eapol_match_cuda(pmk, prf_blocks[None], eapol_blocks[None], target[None],
                                keyver, prep)[0]
    prep = tuple(prep)
    n, v, e = check_eapol(pmk, prf_blocks, eapol_blocks, target, keyver, prep)
    order, prf_sched, eapol_sched = prep
    b = pmk.shape[1]
    out = torch.empty((n, v, b), dtype=torch.bool, device=pmk.device)
    return _launch("eapol", "verify_eapol_launch", pmk, out, pmk.data_ptr(), b, v,
                   order.data_ptr(), prf_sched.data_ptr(), e, eapol_sched.data_ptr() if e else None,
                   target.data_ptr(), n, keyver, out.data_ptr())


def cmac_match_cuda(pmk, prf_blocks, cmac_full, cmac_last, target, last_complete, prep=()):
    """Keyver 3 AES-128-CMAC match over every variant on the GPU ->
    bool[N, V, B] (bool[V, B] for a single net's constants); bit-identical
    to ``ops/verify.eapol_cmac_match_plain``.  ``prep`` as in
    :func:`eapol_match_cuda`."""
    _need_card("cmac", pmk)
    if prf_blocks.dim() == 3:
        return cmac_match_cuda(pmk, prf_blocks[None], cmac_full[None], cmac_last[None],
                               target[None], last_complete, prep)[0]
    prep = tuple(prep)
    n, v, f = check_cmac(pmk, prf_blocks, cmac_full, cmac_last, target, prep)
    prf_sched, words = prep
    b = pmk.shape[1]
    out = torch.empty((n, v, b), dtype=torch.bool, device=pmk.device)
    return _launch("cmac", "verify_cmac_launch", pmk, out, pmk.data_ptr(), b, v,
                   prf_sched.data_ptr(), f, words.data_ptr(), int(bool(last_complete)), n,
                   out.data_ptr())
