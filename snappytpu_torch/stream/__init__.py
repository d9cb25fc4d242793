"""Stream layers of the port: the bounded-memory file codec (filecodec.py).
Framing itself is snappytpu.stream.framing, reused by import."""
