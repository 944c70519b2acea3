"""Client (``client/main.py``): a unit's time outside its pass 2, the mean
over the window's units: get_work, the dict fetch, pass 1 and put_work
(the ``work_unit`` span less its ``pass2`` span)."""


def read(w):
    units = [s["t1"] - s["t0"] for s in w.spans if s["name"] == "work_unit"]
    pass2 = [s["t1"] - s["t0"] for s in w.spans if s["name"] == "pass2"]
    if not units or len(units) != len(pass2):
        return None
    return sum(u - p for u, p in zip(units, pass2)) / len(units)
