"""Verify kernel K3: its device time over all device time in the window's
trace, in percent."""

from port_bench.trace import kernel_seconds

K3 = ("verify_pmkid_kernel", "verify_eapol_kernel", "verify_cmac_kernel")


def read(w):
    if w.trace is None or w.trace["device_s"] <= 0:
        return None
    return 100.0 * kernel_seconds(w.trace, *K3) / w.trace["device_s"]
