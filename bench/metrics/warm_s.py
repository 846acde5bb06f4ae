"""``warm_s``: the benchmark's clock around the warm-up runs, which load the
nvcc library and the Triton passes and capture every graph the traffic
will replay (a served cell: one batch of each warmed lane count)."""


def read(rec):
    return rec.spans["warm_s"]
