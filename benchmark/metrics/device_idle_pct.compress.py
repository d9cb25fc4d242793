"""The share of the traced stretch of a compress cell in which the card ran no
kernel, memcpy or memset, in %."""


def read(view):
    if view.op != "compress" or not view.device:
        return None
    return view.idle_pct()
