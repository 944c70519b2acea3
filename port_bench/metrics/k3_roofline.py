"""Verify kernel K3 (``ops/verify_cuda.py``, ``csrc/verify.cu``): the
instructions the window's PMK columns need in every verify part of their
ESSID group (the frozen census, ``census/``) over what the card issues at
most in K3's device time (the profiler trace), in percent."""

from port_bench.trace import kernel_seconds

K3 = ("verify_pmkid_kernel", "verify_eapol_kernel", "verify_cmac_kernel")


def read(w):
    if w.trace is None or w.peak_inst_per_s is None or w.extra.get("k3_inst") is None:
        return None
    k3_s = kernel_seconds(w.trace, *K3)
    if k3_s <= 0:
        return None
    return 100.0 * w.extra["k3_inst"] / (k3_s * w.peak_inst_per_s)
