"""Uncompressed bytes of the decompress requests completed in the traced
run's measured window, over the window's whole time, in MB/s (10^6 bytes).
The benchmark has no end-to-end decompress rate; this reads the window as
`compress_MBps` reads it for compress.  With several clients, every client's
requests over the window that the last one closes."""


def read(view):
    window = view.window
    if window is None or window.op != "decompress":
        return None
    return sum(r.out_bytes for r in window.requests if not r.failed) / window.seconds / 1e6
