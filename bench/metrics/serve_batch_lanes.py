"""``serve_batch_lanes``: real requests a served batch, mean over the
measured window, from the program's ``serve.batch_size`` counter (batches
by size)."""


def read(rec):
    if rec.mix["kind"] != "serve":
        return None
    by_size = rec.label_deltas("serve.batch_size", "size")
    batches = sum(by_size.values())
    if not batches:
        return None
    return sum(int(s) * c for s, c in by_size.items()) / batches
