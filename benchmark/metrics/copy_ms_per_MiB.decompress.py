"""Device time of the host-to-device and device-to-host copies inside the
request spans of a decompress cell, per MiB of output, in ms/MiB. With
several clients, the copies that start inside the union of the overlapping
request spans, per MiB of every traced request."""

from benchmark import decode_spans


def read(view):
    if not decode_spans.decompress_view(view):
        return None
    ms = 1e3 * view.device_s_in_spans("gpu_memcpy", ("HtoD", "DtoH"))
    return ms / (view.uncompressed / 2**20) if ms > 0 else None
