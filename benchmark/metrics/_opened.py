"""Helpers of the readers of spans that a program may not open (an older
checkout opens none of them): each gives None where the recorded steps
hold no such span."""

from __future__ import annotations

from typing import Any, Dict, Optional

from benchmark import spans


def count(ctx: Dict[str, Any], name: str) -> int:
    """The recorded steps' spans named ``name``, at any depth."""
    s = ctx.get("spans")
    return sum(c for path, c in s["count"].items() if path.split(spans.SEP)[-1] == name) if s else 0


def device_ms(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Device ms a recorded step under ``name`` (``spans.under``), or None
    where no span of that name was opened."""
    return spans.per_step_ms(ctx, "device_s", [name]) if count(ctx, name) else None
