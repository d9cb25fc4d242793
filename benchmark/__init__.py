"""The benchmark of the PyTorch/CUDA port, `snappytpu_torch`, on one H100.

`run.py` runs one cell (a configuration under a traffic mix, as named in the
repository's BENCHMARK.json) once and prints its result line.  Everything it
measures goes through `snappytpu_torch.api`; nothing here imports JAX or the
JAX package, and the reference (`reference.py`, `datagen.py`) imports nothing
of the program.
"""
