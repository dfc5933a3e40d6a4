"""Host-clock arithmetic of the end-to-end metrics: percentiles, rates,
inter-token gaps and time to first token with censoring at the close."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def token_gaps(stamps: dict, t_open: float, t_close: float) -> list:
    """Every gap between consecutive tokens of one request that ends
    inside [t_open, t_close]; ``stamps`` maps a request to the host times
    of its tokens, in order."""
    gaps = []
    for ts in stamps.values():
        for a, b in zip(ts, ts[1:]):
            if t_open <= b <= t_close:
                gaps.append(b - a)
    return gaps


def tokens_in(stamps: dict, t_open: float, t_close: float) -> int:
    """Output tokens emitted inside [t_open, t_close]."""
    return sum(1 for ts in stamps.values() for t in ts
               if t_open <= t <= t_close)


def ttfts(due: dict, first: dict, t_open: float, t_close: float) -> list:
    """Time to first token of every request due inside the window: from
    its due time to its first token, or, when none came by the close, its
    age then, so that a stall shows."""
    out = []
    for rid, t_due in due.items():
        if not t_open <= t_due <= t_close:
            continue
        t_first = first.get(rid)
        out.append((t_first if t_first is not None and t_first <= t_close
                    else t_close) - t_due)
    return out
