"""Blocks a block-route device call of `api.decompress` decodes: the
program's counters `decompress.blocks` over `decompress.device_calls`, over
every decompress call of the run, the warm-up's with them. A program without
those counters reads nothing.  With several clients, the counters sum every
client's calls."""

from benchmark import decode_spans


def read(view):
    if not decode_spans.decompress_view(view):
        return None
    from snappytpu_torch import profiling

    counts = profiling.counters()
    calls = counts.get("decompress.device_calls", 0)
    return counts.get("decompress.blocks", 0) / calls if calls else None
