"""Device time of the host-to-device and device-to-host copies inside the
request spans of a compress cell, per MiB of uncompressed bytes, in ms/MiB.
With several clients, the copies that start inside the union of the
overlapping request spans, per MiB of every traced request."""


def read(view):
    if view.op != "compress":
        return None
    ms = 1e3 * view.device_s_in_spans("gpu_memcpy", ("HtoD", "DtoH"))
    return ms / (view.uncompressed / 2**20) if ms > 0 else None
