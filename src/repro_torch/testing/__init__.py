"""Test-support machinery that ships with the port (a copy of
``repro.testing``).

``repro_torch.testing.faults`` is the deterministic fault-injection
harness: production code calls :func:`~repro_torch.testing.faults.check` /
:func:`~repro_torch.testing.faults.corrupt_text` at named sites, and tests (or
the ``CELLO_FAULTS`` environment variable) arm rules that fail, delay,
or corrupt exactly the calls they name.  See ``docs/robustness.md``.
"""
from . import faults

__all__ = ["faults"]
