"""Timed loops, one module per kind of traffic; a traffic mix's ``driver``
key names its module. Each has ``setup(ctx)``, ``window(ctx, state)`` (an
``Out``) and ``check(ctx, state, out)`` (the numbers the check compares)."""

from typing import NamedTuple


class WindowClosed(Exception):
    """Raised at the close, from inside the program, to abandon the work in
    flight."""


class Out(NamedTuple):
    metrics: dict  # the cell's end-to-end metrics but setup_s
    attempted: int
    failed: int
    record: dict  # what the per-layer metrics' readers read
    sample: object  # what the check compares
