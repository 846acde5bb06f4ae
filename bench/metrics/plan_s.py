"""``plan_s``: the benchmark's clock around trace, analyze, codesign and
lower in set-up (a served cell: the router's first build of its bucket,
the operator included)."""


def read(rec):
    return rec.spans["plan_s"]
