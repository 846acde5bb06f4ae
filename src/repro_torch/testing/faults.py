"""Deterministic fault injection at named sites (a copy of
``repro.testing.faults``: the same site names, spec grammar and
``CELLO_FAULTS`` variable; its rules and its ``faults.injected`` counter
are the port's own).

Production code declares *sites* — stable names at the places failures
happen in the wild — by calling :func:`check` (raise / delay) or
:func:`corrupt_text` / :func:`corrupt_bytes` (payload mangling) with the
site name plus context labels::

    faults.check("exec.compile", backend="cuda")
    blob = faults.corrupt_text("codesign.cache", blob)

When no rules are armed these are a single ``if not _RULES`` — safe on
hot paths.  Tests arm rules with the :func:`inject` context manager, and
operators / CI arm them process-wide with the ``CELLO_FAULTS``
environment variable (parsed once at import; re-read with
:func:`configure_from_env`)::

    CELLO_FAULTS="exec.compile@cuda=fail:x3,exec.dispatch=slow:0.05"

Spec grammar (comma-separated clauses)::

    site[@qualifier]=kind[:seconds][:xN][:skipK]

* ``site`` — the exact site name; ``@qualifier`` additionally requires
  the qualifier to appear among the call's context-label values (so
  ``exec.compile@cuda`` arms the cuda backend only).
* ``kind`` — ``fail`` (raise :class:`InjectedFault`), ``slow`` (sleep
  ``seconds``, default 0.01), or ``corrupt`` (truncate the payload at a
  ``corrupt_*`` site).
* ``xN`` — fire on at most N matching calls (default: every call).
* ``skipK`` — let the first K matching calls through unharmed.

Counting is per-rule, under a lock, so a spec like ``fail:x3`` means
*exactly* the first three matching calls fail — deterministic by
construction, which is what lets the chaos suite assert precise
retry/breaker/fallback behaviour.  Every fired rule bumps the
``faults.injected`` counter (labels: site, kind) on the
``repro_torch.obs`` registry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from .. import obs

__all__ = [
    "InjectedFault", "FaultRule", "check", "corrupt_bytes", "corrupt_text",
    "inject", "inject_spec", "parse_spec", "configure_from_env", "clear",
    "active", "rules",
]

ENV_VAR = "CELLO_FAULTS"

_INJECTED = obs.registry().counter(
    "faults.injected", "fault-injection rules fired (labels: site, kind)")


class InjectedFault(RuntimeError):
    """The exception raised by an armed ``fail`` rule."""


@dataclasses.dataclass
class FaultRule:
    """One armed fault: where it bites, what it does, and how often."""
    site: str
    kind: str = "fail"                 # fail | slow | corrupt
    qualifier: Optional[str] = None    # must appear among ctx label values
    delay_s: float = 0.01              # slow only
    times: Optional[int] = None        # fire at most this many times
    skip: int = 0                      # let the first K matches through
    message: str = ""
    seen: int = 0                      # matching calls observed
    fired: int = 0                     # matching calls actually harmed

    def _matches(self, site: str, ctx: Dict[str, object]) -> bool:
        if self.site != site:
            return False
        if self.qualifier is None:
            return True
        return any(str(v) == self.qualifier for v in ctx.values())

    def _should_fire(self) -> bool:
        """Call with the module lock held; advances this rule's counters."""
        self.seen += 1
        if self.seen <= self.skip:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


_LOCK = threading.Lock()
_RULES: List[FaultRule] = []


def active() -> bool:
    """True when any rule is armed (cheap, lock-free)."""
    return bool(_RULES)


def rules() -> List[FaultRule]:
    """Snapshot of the armed rules (the live objects — read their
    ``seen`` / ``fired`` counters, don't mutate)."""
    with _LOCK:
        return list(_RULES)


def clear() -> None:
    """Disarm everything (including ``CELLO_FAULTS`` rules)."""
    with _LOCK:
        _RULES.clear()


def _arm(rule: FaultRule) -> FaultRule:
    with _LOCK:
        _RULES.append(rule)
    return rule


def _disarm(rule: FaultRule) -> None:
    with _LOCK:
        with contextlib.suppress(ValueError):
            _RULES.remove(rule)


def check(site: str, **ctx) -> None:
    """Fault hook for ``fail`` / ``slow`` rules.  No-op unless armed."""
    if not _RULES:
        return
    delays: List[float] = []
    raised: Optional[FaultRule] = None
    with _LOCK:
        for rule in _RULES:
            if rule.kind == "corrupt" or not rule._matches(site, ctx):
                continue
            if not rule._should_fire():
                continue
            _INJECTED.inc(site=site, kind=rule.kind)
            if rule.kind == "slow":
                delays.append(rule.delay_s)
            else:
                raised = rule
                break
    for d in delays:
        time.sleep(d)
    if raised is not None:
        raise InjectedFault(
            raised.message
            or f"injected fault at {site} ({ctx or 'no context'})")


def corrupt_bytes(site: str, data: bytes, **ctx) -> bytes:
    """Fault hook for payload corruption: an armed ``corrupt`` rule
    truncates the payload to half its length (never valid JSON/pickle
    past trivial sizes).  Returns the payload unchanged when unarmed."""
    if not _RULES:
        return data
    with _LOCK:
        for rule in _RULES:
            if rule.kind != "corrupt" or not rule._matches(site, ctx):
                continue
            if not rule._should_fire():
                continue
            _INJECTED.inc(site=site, kind="corrupt")
            return data[: len(data) // 2]
    return data


def corrupt_text(site: str, data: str, **ctx) -> str:
    """:func:`corrupt_bytes` for text payloads."""
    if not _RULES:
        return data
    out = corrupt_bytes(site, data.encode("utf-8"), **ctx)
    return out.decode("utf-8", errors="ignore")


# -- spec parsing ------------------------------------------------------
def _parse_clause(clause: str) -> FaultRule:
    site_part, sep, action = clause.partition("=")
    if not sep or not site_part or not action:
        raise ValueError(f"bad fault clause {clause!r}: want "
                         "site[@qualifier]=kind[:seconds][:xN][:skipK]")
    site, _, qualifier = site_part.partition("@")
    toks = action.split(":")
    kind = toks[0]
    if kind not in ("fail", "slow", "corrupt"):
        raise ValueError(f"bad fault kind {kind!r} in {clause!r}: "
                         "want fail, slow or corrupt")
    rule = FaultRule(site=site.strip(), kind=kind,
                     qualifier=qualifier.strip() or None)
    for tok in toks[1:]:
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("x") and tok[1:].isdigit():
            rule.times = int(tok[1:])
        elif tok.startswith("skip") and tok[4:].isdigit():
            rule.skip = int(tok[4:])
        else:
            try:
                rule.delay_s = float(tok)
            except ValueError:
                raise ValueError(
                    f"bad fault option {tok!r} in {clause!r}: want a "
                    "seconds float, xN, or skipK") from None
    return rule


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a ``CELLO_FAULTS`` spec into rules (without arming them)."""
    out = []
    for clause in spec.split(","):
        clause = clause.strip()
        if clause:
            out.append(_parse_clause(clause))
    return out


@contextlib.contextmanager
def inject(site: str, kind: str = "fail", *, qualifier: str = None,
           delay_s: float = 0.01, times: Optional[int] = None,
           skip: int = 0, message: str = "") -> Iterator[FaultRule]:
    """Arm one rule for the duration of a ``with`` block.  ``site`` may
    carry an inline ``@qualifier`` (``inject("exec.compile@cuda")``)."""
    if "@" in site and qualifier is None:
        site, _, qualifier = site.partition("@")
    rule = _arm(FaultRule(site=site, kind=kind, qualifier=qualifier,
                          delay_s=delay_s, times=times, skip=skip,
                          message=message))
    try:
        yield rule
    finally:
        _disarm(rule)


@contextlib.contextmanager
def inject_spec(spec: str) -> Iterator[List[FaultRule]]:
    """Arm a full ``CELLO_FAULTS``-grammar spec for a ``with`` block."""
    armed = [_arm(r) for r in parse_spec(spec)]
    try:
        yield armed
    finally:
        for r in armed:
            _disarm(r)


def configure_from_env(env: Optional[Dict[str, str]] = None
                       ) -> List[FaultRule]:
    """Arm rules from ``CELLO_FAULTS`` (idempotent per call: previously
    env-armed rules are replaced, ``inject``-armed ones are kept)."""
    spec = (env if env is not None else os.environ).get(ENV_VAR, "")
    with _LOCK:
        _RULES[:] = [r for r in _RULES if not getattr(r, "_from_env", False)]
    armed = []
    for rule in parse_spec(spec):
        rule._from_env = True  # type: ignore[attr-defined]
        armed.append(_arm(rule))
    return armed


configure_from_env()
