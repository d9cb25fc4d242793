"""The share of the traced stretch of a decompress cell in which the card ran
no kernel, memcpy or memset, in %.  With several clients, the stretch runs
from the first request span's start to the last one's end, whatever their
threads."""

from benchmark import decode_spans


def read(view):
    if not decode_spans.decompress_view(view) or not view.device:
        return None
    return view.idle_pct()
