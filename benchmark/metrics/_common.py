"""Helpers the readers share."""

from __future__ import annotations

from typing import Any, Dict, Optional


def per_step_ms(ctx: Dict[str, Any], families) -> Optional[float]:
    """Device ms a recorded step of the given trace families, or None
    without a trace."""
    tr = ctx.get("trace")
    if not tr:
        return None
    return sum(tr["families"].get(f, 0.0) for f in families) / tr["steps"] * 1e3
