"""``solve_mfu``: the whole solve's share of the chip's peak over the
measured window: the least time the solves completed in it need
(``bench/counts``: bytes at the HBM peak or flops at the vector peak, the
longer) over the window's length."""


def read(rec):
    if rec.mix["kind"] != "solve" or not rec.window.completed:
        return None
    least = rec.counts.least_seconds(rec.counts.solve(rec.cfg),
                                     rec.cfg["dtype"])
    return rec.window.completed * least / rec.window.seconds * 100.0
