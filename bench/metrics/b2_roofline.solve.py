"""``b2_roofline.solve``: B2's (``csr_spmv_kernel``, one thread a row, and
``csr_spmv_blocks_kernel``, row blocks) share of its roofline in the traced
window: the launches times the least time of one product (the CSR triple,
x and y each moved once at the HBM peak, or the flops at the vector peak,
the longer; ``bench/counts``) over their device time."""


def _b2(name):
    return ("csr_spmv_kernel" in name or "csr_spmv_blocks_kernel" in name)


def read(rec):
    if rec.mix["kind"] != "solve" or rec.traced is None:
        return None
    n, t = rec.traced.by_name(_b2)
    if not n or t <= 0:
        return None
    least = rec.counts.least_seconds(rec.counts.spmv(rec.cfg),
                                     rec.cfg["dtype"])
    return n * least / t * 100.0
