"""Rules step (``parallel/step.py`` ``build_rules_step``, ``rules/device.py``):
the device time of every kernel other than K1 and K3, that is the step's
rule expansion, repack and bit packing in plain torch (and the hits
gate's few small ops), over all device time in the window's trace, in
percent.  Copies and sets (``Memcpy``, ``Memset``) are not counted."""

K1 = ("pbkdf2_sha1_pmk_kernel",)
K3 = ("verify_pmkid_kernel", "verify_eapol_kernel", "verify_cmac_kernel")
COPIES = ("Memcpy", "Memset")


def read(w):
    if w.trace is None or w.trace["device_s"] <= 0:
        return None
    other = sum(s for k, s in w.trace["by_name"].items()
                if not k.startswith(COPIES) and not any(n in k for n in K1 + K3))
    return 100.0 * other / w.trace["device_s"]
