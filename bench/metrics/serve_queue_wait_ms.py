"""``serve_queue_wait_ms``: the program's ``serve.queue_wait_s`` (submit to
batch close, a request), mean over the measured window."""


def read(rec):
    if rec.mix["kind"] != "serve":
        return None
    cnt, tot = rec.hist_delta("serve.queue_wait_s")
    return tot / cnt * 1e3 if cnt else None
