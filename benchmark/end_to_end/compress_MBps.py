"""Uncompressed bytes of the compress requests completed in the window, over
the window's whole time, in MB/s (10^6 bytes).  With several clients, every
client's requests, over the window from its opening to the last client's last
return."""


def read(window):
    if window.op != "compress":
        return None
    return sum(r.in_bytes for r in window.requests if not r.failed) / window.seconds / 1e6
