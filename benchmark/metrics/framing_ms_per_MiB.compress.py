"""The host's own framing and copies in a compress cell: the summed time of
the program's `snappy.pack`, `snappy.rows`, `snappy.compact` and
`snappy.join` spans inside the request spans, per MiB of uncompressed bytes,
in ms/MiB.  With several clients, each step counts inside the request span of
its own thread, and the times are summed over the threads."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view):
        return None
    ms = 1e-3 * sum(s.end - s.start for s in program_spans.steps(view, *program_spans.FRAMING))
    return ms / (view.uncompressed / 2**20)
