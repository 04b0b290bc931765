"""Time flash_attention_bwd from two source trees on one card, interleaved.

At chip_smoke.py 11a's shape (`--shape qwen2`: bf16, causal, B 4, H 12
over 2 kv heads, S = T = 2048, D 128: qwen2-1.5b's training layer) or
16d's (`--shape mla`: B 1, H 128 over 128, S = T = 8192, q/k width 192
over v width 128: a deepseek-v3 training layer) each run is a fresh
process whose PYTHONPATH is one tree's `src`, so it builds that tree's
kernels from its own sources into its own build directory. Order A B B A,
so that a drift of the card over the call reaches both trees alike. Each
run reports the median CUDA-event time of 10 calls back to back and of one
call a sample, the worst error against the tree's plain version, and the
registers, shared memory and spills that `-Xptxas -v` printed for the
backward's kernels, the time per call in a CUDA graph (the card alone) and
each CUDA kernel's device time under torch.profiler; with `cuobjdump` on
the PATH (or under CUDA_HOME) also each tensor-core kernel's SASS
instruction count (`--sass-dir` keeps the whole SASS). Needs one CUDA
card:

    python3 scripts/attn_bwd_ab.py --a OTHER_TREE --b . [--shape mla] \
        --out FILE.json

The other tree is an unpacked `git archive` of another commit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

SHAPES = {"qwen2": dict(B=4, S=2048, H=12, K=2, D=128, Dv=128),
          "mla": dict(B=1, S=8192, H=128, K=128, D=192, Dv=128)}
PER, REPEATS = 10, 30


def child(shape: str, seed: int) -> dict:
    """One tree's run, in the process that imports it."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import (flash_attention_bshd,
                                                flash_attention_bwd,
                                                flash_attention_bwd_plain)

    logs = _build.build(("flash_attention_bwd",))
    lib = str(_build.lib_path("flash_attention_bwd"))
    ptxas = [ln.strip() for ln in "".join(logs.values()).splitlines()
             if re.search(r"registers|spill", ln)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S, H, K, D, Dv = (SHAPES[shape][x] for x in "B S H K D Dv".split())
    q, k, v, do = (torch.randn(B, S, h, d, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for h, d in ((H, D), (K, D), (K, Dv), (H, Dv)))
    o, lse = flash_attention_bshd(q, k, v, return_lse=True)

    def kern():
        return flash_attention_bwd(q, k, v, o, lse, do)

    got = kern()
    # the plain version one kv head (and its query heads) at a time
    G, err = H // K, 0.0
    for j in range(K):
        hs = slice(j * G, (j + 1) * G)
        want = flash_attention_bwd_plain(
            q[:, :, hs], k[:, :, j:j + 1], v[:, :, j:j + 1], o[:, :, hs],
            lse[:, hs], do[:, :, hs], round_p=True)
        for g, w in zip((got[0][:, :, hs], got[1][:, :, j:j + 1],
                         got[2][:, :, j:j + 1]), want):
            err = max(err, float((g.float() - w.float()).abs().max()))
    del want, got

    def median_ms(per):
        kern()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPEATS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                kern()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        return float(np.median(times))

    return dict(ms=median_ms(PER), single_ms=median_ms(1),
                graph_ms=graph_ms(kern), kernel_us=kernel_us(kern),
                max_abs_err=err, ptxas=ptxas, lib=lib)


def graph_ms(fn) -> float:
    """The card's time per call of fn() with the host out of the way: PER
    calls captured in one CUDA graph, replayed, the median over PER."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PER):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / PER)
    return float(np.median(times))


def kernel_us(fn) -> dict:
    """Mean device time in us of each CUDA kernel fn() launches, over PER
    calls back to back under torch.profiler (its chrome trace's kernel
    events); empty when the trace holds none."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PER):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = re.sub(r"_GLOBAL__N__\w+?_\d+", "", e["name"])[:90]
            durs.setdefault(name, []).append(e["dur"])
    return {n: sum(d) / len(d) for n, d in durs.items()}


def sass_counts(lib: str, dump: str = None) -> dict:
    """SASS instructions of each tensor-core backward kernel in `lib`;
    with `dump`, the whole SASS written there."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(out)
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            counts[name] += 1
    return {n: c for n, c in counts.items()
            if re.search(r"dkdv_tc|dq_tc", n)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--a", required=True, help="the first tree's root")
    p.add_argument("--b", required=True, help="the second tree's root")
    p.add_argument("--shape", choices=sorted(SHAPES), default="qwen2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--sass-dir", default=None,
                   help="write each tree's SASS there (a.sass, b.sass)")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(child(args.shape, args.seed)),
              flush=True)
        return 0
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    runs = []
    for which in ("a", "b", "b", "a"):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[which], "src"))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--a",
             args.a, "--b", args.b, "--shape", args.shape, "--seed",
             str(args.seed)],
            env=env, cwd=trees[which], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(line[-1][len("RESULT "):])
        res.update(tree=which, root=trees[which])
        runs.append(res)
        print(f"{which} ({trees[which]}): {res['ms']:.4f} ms, {PER} back to "
              f"back; {res['single_ms']:.4f} one call a sample; "
              f"{res['graph_ms']:.4f} in a CUDA graph; max |diff| vs plain "
              f"{res['max_abs_err']:.3e}; kernels (us) "
              + ", ".join(f"{n} {us:.1f}"
                          for n, us in res["kernel_us"].items()), flush=True)
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
    for which in ("a", "b"):
        first = next(r for r in runs if r["tree"] == which)
        dump = args.sass_dir and os.path.join(args.sass_dir, f"{which}.sass")
        first["sass"] = sass_counts(first["lib"], dump)
        print(f"{which}: ptxas", *first["ptxas"], sep="\n  ")
        print(f"{which}: SASS instructions", json.dumps(first["sass"]))
    report = dict(shape=dict(SHAPES[args.shape], name=args.shape), per=PER,
                  repeats=REPEATS, runs=runs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
