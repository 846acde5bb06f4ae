"""``b1_roofline.solve``: B1's generated Triton passes (``main_kernel_<tag>``
and ``finalize_kernel_<tag>``, one tag a pass) against their roofline in
the traced window: the least bytes of every B1 launch the program made
there, which the program counts itself (its ``exec.stream_bytes``
counter: each streamed operand and resident right-hand side read once,
each streamed product and scalar written once, the partials between a
pass's two kernels written and read once), at the HBM peak
(``bench/counts``), over the device time of those kernels.

Bytes alone bound B1 here: a vector pass does at most 2 flops (an axpy's
or a dot's multiply and add) for each 8 bytes it moves in fp64, 0.25
flops a byte, and the H100's fp64 ridge lies at about 10 flops a byte
(34 TFLOP/s over 3.35 TB/s).  The counter and the trace cover the same
replays: the traced window starts after a synchronize and ends with one.
A program without the counter, or a trace without a B1 kernel, reads
nothing."""


def _b1(name):
    return name.startswith("main_kernel") or name.startswith("finalize_kernel")


def read(rec):
    if rec.mix["kind"] != "solve" or rec.traced is None:
        return None
    nbytes = rec.counter_delta("exec.stream_bytes", traced=True)
    _n, t = rec.traced.by_name(_b1)
    if nbytes <= 0 or t <= 0:
        return None
    return nbytes / rec.counts.PEAKS["hbm_bytes_per_s"] / t * 100.0
