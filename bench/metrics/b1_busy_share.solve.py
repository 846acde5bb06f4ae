"""``b1_busy_share.solve``: B1's generated Triton passes (``main_kernel``
and ``finalize_kernel``) as a share of the device's busy time in the
traced window.  Their bytes depend on how a plan fuses, so no roofline."""


def _b1(name):
    return name.startswith("main_kernel") or name.startswith("finalize_kernel")


def read(rec):
    if rec.mix["kind"] != "solve" or rec.traced is None:
        return None
    busy = rec.traced.busy_s()
    _n, t = rec.traced.by_name(_b1)
    if not busy or not t:
        return None
    return t / busy * 100.0
