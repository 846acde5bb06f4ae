"""CSR operand generators: one module a pattern (``<pattern>.py``), found
by the name a configuration gives."""
