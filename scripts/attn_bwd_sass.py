"""Compare flash_attention_bwd's SASS between two source trees, kernel by
kernel, instruction for instruction.

Each tree's `csrc/flash_attention_bwd.cu` is built by that tree's own
`kernels/_build.py` (a fresh process whose PYTHONPATH is the tree's `src`;
both builds run side by side), then `cuobjdump -sass` lists every kernel's
instructions (addresses dropped) and `cu++filt` names them. A kernel that
takes one width in one tree and a (q/k width, v width) pair in the other
is paired by name: `dkdv_kernel<float, 64>` with `dkdv_kernel<float, 64,
64>`, `tc::dkdv_tc256` with `tc::dkdv_tc_wide<256, 256>` (the same for
dq). Prints each kernel of tree A with its instruction counts and whether
tree B's is identical, then the kernels only B has. Needs `nvcc`,
`cuobjdump` and `cu++filt` (the CUDA toolkit), no card:

    python3 scripts/attn_bwd_sass.py --a OTHER_TREE --b . --out FILE.json

Exits 1 if a kernel of A is missing from B or differs, unless its name
matches `--allow` (a regular expression).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

BUILD = ("from repro_torch.kernels import _build; "
         "_build.build(('flash_attention_bwd',)); "
         "print('LIB', _build.lib_path('flash_attention_bwd'))")


def tool(name: str) -> str:
    found = shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if not os.path.isfile(found):
        raise SystemExit(f"{name} not found")
    return found


def normalise(name: str) -> str:
    """A demangled kernel name without its namespace, casts and
    parameters, a (D, D) pair written as the one width."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"^(?:<unnamed>|\(anonymous namespace\))::", "", name)
    name = re.sub(r"\((?:int|bool)\)", "", name).split("(", 1)[0]
    name = re.sub(r"^((?:dkdv|dq)_kernel<[^,]+), (\d+), \2>$", r"\1, \2>",
                  name)
    return re.sub(r"^tc::(dkdv|dq)_tc_wide<256, 256>$", r"tc::\1_tc256",
                  name)


def sass(lib: str) -> dict:
    """{normalised kernel name: [instructions]} of one library."""
    out = subprocess.run([tool("cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
            if m:
                kernels[name].append(m.group(1))
    mangled = list(kernels)
    names = subprocess.run([tool("cu++filt")], input="\n".join(mangled),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for m, n in zip(mangled, names):
        if normalise(n) in out:
            raise SystemExit(f"two kernels named {normalise(n)}: {n}")
        out[normalise(n)] = kernels[m]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--a", required=True, help="the first tree's root")
    p.add_argument("--b", required=True, help="the second tree's root")
    p.add_argument("--allow", default=None,
                   help="kernels of A that may differ or be missing in B")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    procs = {}
    for which in ("a", "b"):
        root = os.path.abspath(getattr(args, which))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        procs[which] = subprocess.Popen(
            [sys.executable, "-c", BUILD], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    code = {}
    for which, proc in procs.items():
        out = proc.communicate()[0]
        lib = [ln[4:] for ln in out.splitlines() if ln.startswith("LIB ")]
        if proc.returncode or not lib:
            print(out[-4000:], file=sys.stderr)
            return 1
        code[which] = sass(lib[-1])
    rows, bad = {}, []
    for n in sorted(code["a"]):
        a, b = code["a"][n], code["b"].get(n)
        rows[n] = dict(a=len(a), b=None if b is None else len(b),
                       identical=a == b)
        print(f"{n}: a {len(a)}, b {rows[n]['b']} instructions, identical "
              f"{a == b}")
        if a != b and not (args.allow and re.search(args.allow, n)):
            bad.append(n)
    for n in sorted(set(code["b"]) - set(code["a"])):
        rows[n] = dict(a=None, b=len(code["b"][n]), identical=False)
        print(f"{n}: only in b, {len(code['b'][n])} instructions")
    print(f"kernels of a that differ in b: {bad or 'none'}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(a=args.a, b=args.b, kernels=rows, differ=bad), f,
                      indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
