"""The share of a compress cell's traced stretch in which the card ran
nothing while the host was inside the program's `snappy.pack`, `snappy.rows`,
`snappy.compact` or `snappy.join` spans, in %.  With several clients, the card
idle while any thread was inside such a span of its own request, each second
counted once."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view) or not view.device:
        return None
    return 100.0 * program_spans.idle_s(view, program_spans.steps(view, *program_spans.FRAMING)) / view.window_s()
