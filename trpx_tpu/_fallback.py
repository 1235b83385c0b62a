"""One-shot fallback warnings for perf-critical degradations.

Host-side helpers degrade gracefully to a slower-but-correct path (the
pure-Python codec or walk when the native C++ library cannot be built,
a real header walk when a sidecar's tables fail validation). Silent
degradation turns an environment regression into an unexplained perf
drop, so every such fallback funnels through
:func:`warn_once` — one RuntimeWarning per site per process, carrying
the triggering exception.
"""

from __future__ import annotations

import warnings

_seen: set[str] = set()


def warn_once(site: str, exc: BaseException | None = None,
              detail: str = "") -> None:
    """Emit one RuntimeWarning for ``site`` per process.

    ``site``: stable identifier (e.g. "parallel.measured_schedule").
    ``exc``: the exception that triggered the fallback, if any.
    ``detail``: what the fallback degrades to.
    """
    if site in _seen:
        return
    _seen.add(site)
    msg = f"trpx_tpu fallback at {site}"
    if detail:
        msg += f" ({detail})"
    if exc is not None:
        msg += f": {type(exc).__name__}: {exc}"
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
