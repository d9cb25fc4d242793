"""`compress_MBps` where the benchmark holds it to no bound: the end-to-end
reader's number, taken from the traced run's measured window. With several
clients, every client's requests over the window that the last one closes."""

from pathlib import Path

from benchmark import cells

END_TO_END = cells._reader(Path(__file__).resolve().parent.parent / "end_to_end", "compress_MBps")


def read(view):
    return None if view.window is None else END_TO_END.read(view.window)
