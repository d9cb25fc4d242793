"""What the decompress cells' readers of the program's own steps read: the
spans `snappy.<step>` that `api.decompress` records (`program_spans`).  A
view counts as a decompress view only where the program's
`snappy.decompress` spans show its calls inside the request spans, so a
trace without them reads nothing (None)."""

from __future__ import annotations

from . import program_spans

FRAMING = ("scan", "split", "tape", "compact", "join")  # the host's framing of api.decompress: parse, rows, tapes, output


def decompress_view(view) -> bool:
    """A decompress cell's traced stretch with the program's request spans in it."""
    return view.op == "decompress" and bool(program_spans.steps(view, "decompress"))
