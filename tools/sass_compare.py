"""Compare the SASS of CUDA kernels between two builds, on a machine with nvcc.

Compiles each of two sources for sm_90a into a cubin (the port's nvcc flags,
grok_tpu_torch.kernels.NVCC_FLAGS, without the library flags, plus each
side's own), disassembles both with cuobjdump and prints one JSON line a
pair of kernels: whether their instructions are the same (addresses and
encodings dropped), their instruction counts and the first lines that
differ. A kernel is named by a substring of its mangled name; ``--pair
all`` pairs every kernel of A with the kernel of B of the same name.

Usage (from the repo root; the flags after ``--a-flags``/``--b-flags``):
    python tools/sass_compare.py --a old.cu --b grok_tpu_torch/csrc/strip_h.cu \\
        --b-flags=-fmad=false --pair dwt53_fwd_rows=fwd_rowsI5Fwd53
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from grok_tpu_torch import kernels  # noqa: E402

_LIB_FLAGS = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}


def sass(source: str, flags: list[str], tmp: Path) -> dict[str, list[str]]:
    """Each kernel of ``source`` (its mangled name) and its instructions."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    cubin = tmp / f"{Path(source).stem}-{len(list(tmp.iterdir()))}.cubin"
    base = [f for f in kernels.NVCC_FLAGS if f not in _LIB_FLAGS]
    subprocess.run([nvcc, *base, *flags, "-cubin", "-o", str(cubin), source], check=True)
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*\*/)?\s*$", line)
        if name and m and m.group(1):
            out[name].append(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--a-flags", default="")
    ap.add_argument("--b-flags", default="")
    ap.add_argument("--pair", action="append", required=True,
                    help="substrings KA=KB of two kernels' mangled names, or 'all'")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        a = sass(args.a, args.a_flags.split(), Path(d))
        b = sass(args.b, args.b_flags.split(), Path(d))
    pairs = []
    for p in args.pair:
        if p == "all":
            pairs += [(k, k) for k in a]
        else:
            ka, kb = p.split("=")
            pairs.append((next(k for k in a if ka in k), next(k for k in b if kb in k)))
    same_all = True
    for ka, kb in pairs:
        ia, ib = a[ka], b.get(kb, [])
        diff = [(i, x, y) for i, (x, y) in enumerate(zip(ia, ib)) if x != y]
        same = ia == ib
        same_all &= same
        print(json.dumps({"a": ka, "b": kb, "same": same, "instructions": [len(ia), len(ib)],
                          "first_differences": diff[:5]}), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
