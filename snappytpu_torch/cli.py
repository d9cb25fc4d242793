"""Command-line interface of the port — snappytpu.cli with the port as its
`device` backend.

Flag-compatible with the reference CLI (`snappy [-c|-b|-d] [-r] in out`):
`-c` compresses with the fast profile, `-b` with the dense profile, `-d`
decompresses, `-r` prints a results report.  Extras as in snappytpu.cli:
`--backend device|cpu|model`, `--csv FILE`, the `roundtrip` verb and
`--window-mb` (file-to-file through the port's bounded-memory file codec).
`--device` names the torch device of the `device` backend (default `cuda`;
the CLI refuses it when torch sees no CUDA GPU).  The `cpu` and `model`
backends are the port's copies of snappytpu's JAX-free host codecs.

Usage:
  python -m snappytpu_torch.cli -c in out
  python -m snappytpu_torch.cli -d in.snappy out --device cuda:0
  python -m snappytpu_torch.cli roundtrip in --device cpu
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import torch

from .bench.metrics import Result, Timer, write_result_csv
from .format import constants as C


def _codec(backend: str, profile: str, device):
    if backend == "device":
        from . import api

        return functools.partial(api.compress, profile=profile, device=device), functools.partial(
            api.decompress, device=device)
    if backend == "cpu":
        from . import cpu

        if cpu.available:
            return cpu.compress, cpu.decompress
        print("native backend unavailable, falling back to model", file=sys.stderr)
    from . import model

    return model.compress, model.decompress


def _report(args, result: Result) -> None:
    if args.r:
        print(result.report())
    if args.csv:
        write_result_csv(args.csv, result)


def main(argv=None):
    p = argparse.ArgumentParser(prog="snappytpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", action="store_true", help="compress infile to outfile (fast profile)")
    p.add_argument("-b", action="store_true", help="compress (dense profile)")
    p.add_argument("-d", action="store_true", help="decompress infile to outfile")
    p.add_argument("-r", action="store_true", help="print results report")
    p.add_argument("paths", nargs="*", help="[verb] infile [outfile]")
    p.add_argument("--backend", default="device", choices=["device", "cpu", "model"])
    p.add_argument("--device", default="cuda", help="torch device of the device backend (default cuda)")
    p.add_argument("--csv", help="append a reference-schema results row to FILE")
    p.add_argument(
        "--window-mb", type=int, default=0, metavar="MB",
        help="stream file-to-file through a bounded window of this many MB "
             "(device backend; 0 = auto: whole-buffer below 512 MB, 512 MB windows above)",
    )
    args = p.parse_args(argv)

    # getopt-style flags take priority; otherwise the first positional may be
    # a verb (compress/decompress/roundtrip)
    paths = list(args.paths)
    verb = None
    if paths and paths[0] in ("compress", "decompress", "roundtrip"):
        verb = paths.pop(0)
    if verb is None and (args.c or args.b or args.d):
        verb = "decompress" if args.d else "compress"
    if verb is None:
        p.error("one of -c/-b/-d or a verb is required")
    infile = paths[0] if paths else None
    outfile = paths[1] if len(paths) > 1 else None
    if verb == "roundtrip":
        if not infile:
            p.error("infile required")
    elif not infile or not outfile:
        p.error("infile and outfile required")
    device = torch.device(args.device)
    if args.backend == "device" and device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: torch sees no CUDA GPU (pass --device cpu or another --backend)")

    # -c maps to the fast profile, -b to dense, as the reference's hash-table
    # and BST compressors
    profile = "fast" if (args.c and not args.b) else "dense"

    # bounded-memory streaming path: explicit via --window-mb, automatic for
    # files too large to comfortably double-buffer in host RAM
    in_size = os.path.getsize(infile)
    auto_stream = args.window_mb == 0 and in_size >= (512 << 20)
    if (args.window_mb > 0 or auto_stream) and args.backend == "device" and verb in ("compress", "decompress"):
        from .stream import filecodec

        window_blocks = max(((args.window_mb or 512) << 20) // C.MAX_BLOCK_SIZE, 1)
        t = Timer().start()
        if verb == "compress":
            out_size = filecodec.compress_file(infile, outfile, profile, window_blocks=window_blocks, device=device)
        else:
            out_size = filecodec.decompress_file(infile, outfile, window_blocks=window_blocks, device=device)
        _report(args, Result(phase=verb, input_size=in_size, output_size=out_size,
                             time_taken=t.stop(), backend=args.backend))
        return 0

    compress, decompress = _codec(args.backend, profile, device)
    with open(infile, "rb") as f:
        data = f.read()

    t = Timer().start()
    if verb == "roundtrip":
        comp = compress(data)
        out = decompress(comp)
        took = t.stop()
        if out != data:
            print("ROUNDTRIP MISMATCH", file=sys.stderr)
            return 1
        print(f"roundtrip ok: {len(data)} bytes, ratio {len(data) / max(len(comp), 1):.4f}, "
              f"{took * 1000:.1f} ms ({args.backend})")
        return 0
    out = compress(data) if verb == "compress" else decompress(data)
    took = t.stop()
    with open(outfile, "wb") as f:
        f.write(out)
    _report(args, Result(phase=verb, input_size=len(data), output_size=len(out),
                         time_taken=took, backend=args.backend))
    return 0


if __name__ == "__main__":
    sys.exit(main())
