"""snappytpu_torch — the Snappy block codec of `snappytpu`, ported to
PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors the module names of `snappytpu` and is held against it
byte for byte.  Its hand-written CUDA kernels (csrc/) are built by nvcc at
first use on a CUDA tensor (_build.py); importing the package, or running
it on CPU tensors, needs neither nvcc nor a GPU.  The layers with no JAX in
them (format, model, stream.framing, the native C++ runtime cpu, the corpora
and metrics of bench) are the port's own copies of `snappytpu`'s, under the
same names: the port imports nothing of `snappytpu`.
"""

__version__ = "0.1.0"
