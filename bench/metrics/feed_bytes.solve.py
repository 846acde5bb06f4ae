"""``feed_bytes.solve``: bytes a ``run()`` copies into its graph's leaf
buffers, from the program's ``exec.donated_bytes`` counter over the
measured window, per solve."""


def read(rec):
    if rec.mix["kind"] != "solve" or not rec.window.completed:
        return None
    return rec.counter_delta("exec.donated_bytes") / rec.window.completed
