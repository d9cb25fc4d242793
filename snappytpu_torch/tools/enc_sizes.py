"""Per-fixture compressed sizes of both encoder profiles — the counterpart
of the JAX package's tools/enc_sizes.py: for each fixture of
corpus.edge_case_corpus() except `empty`, the size of api.compress with
dense and with fast on --device, beside the reference binary's best where
one is given, and the CSV size_margins.csv in --out.

    python -m snappytpu_torch.tools.enc_sizes --out DIR [--ref-cli PATH]
        [--real-dir DIR] [--device cuda]

--ref-cli names a built reference binary (`snappy -c|-b in out`); it runs
with its own directory as the working directory, as in the JAX tool, and
gives `ref` (the smaller of its hash and BST outputs) and the margins.
Without it `ref` is -1 and every fixture reads OK, as in the JAX tool
without the reference checkout.  --real-dir adds the first six files of a
directory (sorted by name, those above 1 KiB, cut to 256 KiB), as the JAX
tool adds the reference checkout's files.  The CSV goes only to --out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from .. import api
from ..bench import corpus
from ._staged import device_of


def real_files(directory: str) -> dict[str, bytes]:
    """The files of a directory, by name: the JAX corpus.reference_files
    for one directory."""
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def fixtures(real_dir: str | None = None) -> dict[str, bytes]:
    """The edge-case corpus without `empty`, plus real files."""
    fix = {k: v for k, v in corpus.edge_case_corpus().items() if k != "empty"}
    if real_dir:
        fix.update({f"real:{name}": data[:262144] for name, data in sorted(real_files(real_dir).items())[:6]
                    if len(data) > 1024})
    return fix


def ref_best(exe: str, data: bytes) -> int:
    """The reference binary's smaller output size of -c (hash) and -b (BST)."""
    exe = os.path.abspath(exe)
    with tempfile.TemporaryDirectory() as d:
        src, comp = os.path.join(d, "in"), os.path.join(d, "out")
        with open(src, "wb") as f:
            f.write(data)
        best = None
        for flag in ("-c", "-b"):
            subprocess.run([exe, flag, src, comp], capture_output=True, timeout=300,
                           cwd=os.path.dirname(exe), check=True)
            s = os.path.getsize(comp)
            best = s if best is None else min(best, s)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for size_margins.csv")
    ap.add_argument("--ref-cli", help="a built reference binary")
    ap.add_argument("--real-dir", help="a directory of real files to add")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    bad = 0
    rows = []
    for name, data in sorted(fixtures(args.real_dir).items()):
        rb = ref_best(args.ref_cli, data) if args.ref_cli else -1
        dn = len(api.compress(data, profile="dense", device=dev))
        fa = len(api.compress(data, profile="fast", device=dev))
        ok = "OK " if (rb < 0 or dn <= rb) else "FAIL"
        bad += ok == "FAIL"
        rows.append((name, len(data), rb, dn, fa, rb - dn, rb - fa))
        print(f"{ok} {name:28s} ref {rb:8d}  dense {dn:8d} ({rb - dn:+6d})  fast {fa:8d} ({rb - fa:+6d})", flush=True)
    print("STRICT-CONTRACT:", "PASS" if bad == 0 else f"{bad} FAIL")
    os.makedirs(args.out, exist_ok=True)
    out_csv = os.path.join(args.out, "size_margins.csv")
    with open(out_csv, "w") as f:
        f.write("fixture,input_size,ref_best,dense,fast,dense_margin,fast_margin\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    print(f"wrote {out_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
