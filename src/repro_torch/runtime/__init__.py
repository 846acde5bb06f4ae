"""`repro_torch.runtime` — the restart skeleton that serving shares.

Only :func:`run_with_restarts` is ported so far; the elastic pieces of the
JAX package's ``runtime`` (heartbeats, stragglers, elastic meshes) come
with training (ROADMAP.md)."""
from .fault_tolerance import run_with_restarts

__all__ = ["run_with_restarts"]
