"""The PBKDF2-HMAC-SHA1 CUDA kernel: build, bind and launch.

The kernel (``csrc/pbkdf2_sha1.cu``) replaces the Pallas TPU kernel
``dwpa_tpu/ops/pbkdf2_pallas.py:pbkdf2_sha1_pmk_pallas``; its source
note says what bounds it and how.  It is compiled at first use by
``ops/_nvcc.py`` into a shared library with a plain C interface and
loaded with ``ctypes``.  Nothing here runs at import time, so the CPU
tests import this module on a machine without ``nvcc``.

The plain version of the same function is ``ops/pbkdf2.pbkdf2_sha1_pmk``;
``models/m22000._pmk_impl`` takes it only for a tensor on the CPU.
"""

import ctypes
import threading

import torch

from . import _nvcc
from .pbkdf2 import check_inputs

SOURCE = _nvcc.CSRC / "pbkdf2_sha1.cu"

#: Kernel launches made by :func:`pbkdf2_sha1_pmk_cuda` in this process.
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()  # first use may come from any thread


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
            fn = lib.pbkdf2_sha1_pmk_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def pbkdf2_sha1_pmk_cuda(pw, salt1, salt2, iterations=4096):
    """PMKs for a candidate batch on the GPU -> int32[8, B] (big-endian
    PMK words), bit-identical to ``ops/pbkdf2.pbkdf2_sha1_pmk``.

    ``pw``: contiguous int32[B, W] on a CUDA device, W in {4, 8, 16};
    ``salt1``/``salt2``: contiguous int32[16] or int32[B, 16] on the same
    device.  Launches on the current stream and does not synchronise.
    """
    global LAUNCHES
    if not pw.is_cuda:
        raise ValueError("pbkdf2_sha1_pmk_cuda needs CUDA tensors")
    check_inputs(pw, salt1, salt2)
    if not (pw.is_contiguous() and salt1.is_contiguous() and salt2.is_contiguous()):
        raise ValueError("pbkdf2_sha1_pmk_cuda needs contiguous tensors")
    if not 1 <= iterations < 2**31:
        raise ValueError(f"iterations out of range: {iterations}")
    fn = _library().pbkdf2_sha1_pmk_launch
    b, w = pw.shape
    out = torch.empty((8, b), dtype=torch.int32, device=pw.device)
    with torch.cuda.device(pw.device):
        stream = torch.cuda.current_stream(pw.device).cuda_stream
        err = fn(pw.data_ptr(), w, salt1.data_ptr(), salt2.data_ptr(),
                 16 if salt1.dim() == 2 else 0, iterations, out.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"pbkdf2_sha1_pmk kernel launch failed: cudaError {err}")
    if b:
        LAUNCHES += 1
    return out
