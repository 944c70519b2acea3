"""PBKDF2 kernel K1 (``ops/pbkdf2_cuda.py``, ``csrc/pbkdf2_sha1.cu``): the
instructions the window's PMKs need (the frozen census, ``census/``)
over what the card issues at most in K1's device time (the profiler
trace), in percent.  Batches K1 runs on padding (pass 1's short batch)
count in its time and not in its work."""

from port_bench import census
from port_bench.trace import kernel_seconds


def read(w):
    if w.trace is None or w.peak_inst_per_s is None:
        return None
    k1_s = kernel_seconds(w.trace, "pbkdf2_sha1_pmk_kernel")
    if k1_s <= 0:
        return None
    return 100.0 * census.k1_inst_per_pmk() * w.pmks / (k1_s * w.peak_inst_per_s)
