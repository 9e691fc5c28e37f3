"""Compare the machine code (SASS) of the port's kernels between two builds
of its CUDA library, for example the parent commit's and this tree's.

    python scripts/torch_sass_compare.py LIB_A LIB_B [--kernels NAME,...] [--show N]

Each LIB is a built `libi360_attn_*.so` (`kernels.load_library()._name`
gives the path of the running tree's). Both are dumped with
`cuobjdump -sass` and split by function; for every function in either
library whose mangled name contains one of --kernels (default: all) it
prints one line, `identical`, `differs` (with the instruction count of
each side and of the instructions that differ; --show N also prints the
first N such pairs) or `only in A` / `only in B`, then a JSON summary of
the counts. Instructions are compared as text without their addresses and
encodings, and with branch labels (`.L_x_N`, numbered across a whole
library) renumbered in order of appearance within the function.
Identical SASS means identical work on the card, so a change to a shared
header that leaves a kernel's SASS as it was needs no new timing of that
kernel. Needs the CUDA toolkit's cuobjdump (beside nvcc); no GPU.
"""
import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from imagine360_tpu_torch.ops import kernels  # noqa: E402


def _normalise(lines: list) -> list:
    """Instruction texts without address and encoding, labels renumbered."""
    labels = {}

    def label(m):
        return labels.setdefault(m.group(0), f".L{len(labels)}")
    out = []
    for line in lines:
        text = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", line).split(";")[0].strip()
        out.append(re.sub(r"\.L_x_\d+", label, text))
    return out


def functions(lib: str) -> dict:
    """Mangled function name -> its normalised SASS instructions."""
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None and line.strip().startswith("/*") and ";" in line:
            out[name].append(line.strip())
    return {n: _normalise(lines) for n, lines in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--kernels", default="", help="comma list of name parts (all)")
    ap.add_argument("--show", type=int, default=0, help="differing pairs to print a function")
    args = ap.parse_args(argv)
    parts = [p for p in args.kernels.split(",") if p]
    a, b = functions(args.lib_a), functions(args.lib_b)
    counts = {"identical": 0, "differs": 0, "only in A": 0, "only in B": 0}
    for name in sorted(set(a) | set(b)):
        if parts and not any(p in name for p in parts):
            continue
        if name not in b:
            verdict = "only in A"
        elif name not in a:
            verdict = "only in B"
        elif a[name] == b[name]:
            verdict = "identical"
        else:
            pairs = [(x, y) for x, y in zip(a[name], b[name]) if x != y]
            verdict = (f"differs ({len(a[name])} / {len(b[name])} instructions, "
                       f"{len(pairs)} differ)")
        counts[verdict.split(" (")[0]] += 1
        print(f"{name} {verdict}")
        if verdict.startswith("differs"):
            for x, y in pairs[:args.show]:
                print(f"    A: {x}\n    B: {y}")
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
