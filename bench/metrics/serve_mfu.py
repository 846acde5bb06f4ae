"""``serve_mfu``: the served requests' share of the chip's peak over the
measured window: each request completed in it charged its own solve's
vectors and ``1 / max_batch_size`` of the operand a product
(``bench/counts``), at the HBM peak or the vector peak, the longer, over
the window's length."""


def read(rec):
    if rec.mix["kind"] != "serve" or not rec.window.completed:
        return None
    share = 1.0 / int(rec.mix["max_batch_size"])
    least = rec.counts.least_seconds(rec.counts.solve(rec.cfg, share),
                                     rec.cfg["dtype"])
    return rec.window.completed * least / rec.window.seconds * 100.0
