"""Activation-sharding context (counterpart of ``repro/launch/shardctx.py``).

The model calls ``constrain(x, role)`` at the reference's sites (roles
``"hidden"`` (B, S, d), ``"logits"`` (B, C, V), ``"gathered_weight"``).  The
port has no GSPMD, so it returns ``x`` unchanged; under :func:`rules` it
records the spec the rule gives each role, which the dry-run writes into
its record.
"""
from __future__ import annotations

import contextlib

_RULES = None
_SEEN = None


@contextlib.contextmanager
def rules(rule_fn):
    """``rule_fn(role, shape) -> P | None``.  Yields the record:
    ``{role: {"calls": n, "specs": [spec as text, ...]}}``."""
    global _RULES, _SEEN
    prev = _RULES, _SEEN
    _RULES, _SEEN = rule_fn, {}
    try:
        yield _SEEN
    finally:
        _RULES, _SEEN = prev


def constrain(x, role: str):
    if _RULES is not None:
        spec = _RULES(role, tuple(x.shape))
        rec = _SEEN.setdefault(role, {"calls": 0, "specs": []})
        rec["calls"] += 1
        text = repr(spec)
        if text not in rec["specs"]:
            rec["specs"].append(text)
    return x
