"""The host's own framing in a decompress cell: the summed time of the
program's `snappy.scan`, `snappy.split`, `snappy.tape`, `snappy.compact` and
`snappy.join` spans inside the request spans, per MiB of output, in ms/MiB.
With several clients, each step counts inside the request span of its own
thread, and the times are summed over the threads."""

from benchmark import decode_spans, program_spans


def read(view):
    if not decode_spans.decompress_view(view):
        return None
    ms = 1e-3 * sum(s.end - s.start for s in program_spans.steps(view, *decode_spans.FRAMING))
    return ms / (view.uncompressed / 2**20)
