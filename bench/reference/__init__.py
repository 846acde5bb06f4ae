"""Plain references: one module a workload (``<workload>.py``), found by
the name a configuration gives."""
