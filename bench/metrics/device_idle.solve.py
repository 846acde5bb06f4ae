"""``device_idle.solve``: the share of the traced window in which no
kernel, copy or set ran on the device (1 - the union of their intervals
over the window), from ``torch.profiler``."""


def read(rec):
    if rec.mix["kind"] != "solve" or rec.traced is None:
        return None
    busy = rec.traced.busy_s()
    if busy is None:
        return None
    return (1.0 - busy / rec.traced.window_s) * 100.0
