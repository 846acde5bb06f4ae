"""``b2_lanes_roofline``: B2's lane form (``csr_spmv_lanes_kernel``) share
of its roofline in the traced window: each launch charged the operand once
and each lane's x and y once (lanes as launched: a batch padded to a power
of two, the mean of the traced window's batches from ``serve.batch_size``),
at the HBM peak or the vector peak, the longer, over their device time."""


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def read(rec):
    if rec.mix["kind"] != "serve" or rec.traced is None:
        return None
    n, t = rec.traced.by_name(lambda name: "csr_spmv_lanes_kernel" in name)
    by_size = rec.label_deltas("serve.batch_size", "size", traced=True)
    batches = sum(by_size.values())
    if not n or t <= 0 or not batches:
        return None
    lanes = sum(_next_pow2(s) * c for s, c in by_size.items()) / batches
    least = rec.counts.least_seconds(rec.counts.spmv(rec.cfg, lanes),
                                     rec.cfg["dtype"])
    return n * least / t * 100.0
