"""Stream layers of the port: host framing (framing.py, the port's copy of
snappytpu.stream.framing) and the bounded-memory file codec (filecodec.py)."""
