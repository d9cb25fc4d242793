"""The share of the traced stretch of a compress cell in which the card ran
no kernel, memcpy or memset, in %.  With several clients, the stretch runs
from the first request span's start to the last one's end, whatever their
threads."""


def read(view):
    if view.op != "compress" or not view.device:
        return None
    return view.idle_pct()
