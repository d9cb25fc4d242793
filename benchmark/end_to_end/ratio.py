"""Uncompressed bytes over stream bytes, summed over every compress request
completed in the window: the stored size users pay for.  With several clients,
every client's requests."""


def read(window):
    if window.op != "compress":
        return None
    done = [r for r in window.requests if not r.failed]
    return sum(r.in_bytes for r in done) / sum(r.out_bytes for r in done)
