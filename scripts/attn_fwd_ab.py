"""Time flash_attention (the forward) from two source trees on one card,
interleaved.

Two shapes: `--shape mla`, chip_smoke.py 16a's (bf16, causal, B 2, 128
heads over 128, S = T = 8192, q/k width 192 over v width 128:
deepseek-v3-671b's prefill layer), and `--shape qwen2`, phase 9's (B 4,
12 heads over 2, S = T = 2048, width 128). Each run is a fresh process
whose PYTHONPATH is one tree's `src`, so it builds that tree's kernels
from its own sources into its own build directory. Order A B B A, so that
a drift of the card over the call reaches both trees alike. Each run
reports the median CUDA-event time of 10 calls back to back, of one call
a sample and of 10 calls in a CUDA graph (the card alone), the worst
error against the tree's plain version (round_p) and whether the output
equals the other tree's bit for bit (an order of the blocks changes no
block's arithmetic); then each tree's tensor-core kernels' SASS:
instruction counts, and whether the two trees' are identical (with
`cuobjdump` on the PATH or under CUDA_HOME). Needs one CUDA card:

    python3 scripts/attn_fwd_ab.py --a OTHER_TREE --b . --shape mla

The other tree is an unpacked `git archive` of another commit, or of this
one with an edit: for the launch-order measurement of PERF.md (PR 28) the
MLA instance's head-major order was switched back to the tile-major one
in the other tree's `src/repro_torch/csrc/flash_attention.cu`
(`if constexpr (DQK != DV)` in `flash_attention_tc` made
`if constexpr (false)`). A tree whose kernel takes no q/k width 192 over
v width 128 (before PR 28) runs `--shape qwen2` only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

SHAPES = {"mla": dict(B=2, S=8192, H=128, K=128, D=192, Dv=128),
          "qwen2": dict(B=4, S=2048, H=12, K=2, D=128, Dv=128)}
PER, REPEATS = 10, 20


def child(shape: str, seed: int) -> dict:
    """One tree's run, in the process that imports it."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import (flash_attention_bshd,
                                                flash_attention_bshd_plain)

    _build.build(("flash_attention",))
    s = SHAPES[shape]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s["B"], s["S"], h, d, generator=gen, device=dev)
               .to(torch.bfloat16)
               for h, d in ((s["H"], s["D"]), (s["K"], s["D"]),
                            (s["K"], s["Dv"])))

    def kern():
        return flash_attention_bshd(q, k, v)

    got = kern()
    err = float((got.float() - flash_attention_bshd_plain(
        q, k, v, round_p=True).float()).abs().max())
    digest = hashlib.sha256(got.view(torch.int16).cpu().numpy()
                            .tobytes()).hexdigest()

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
                graph_ms=graph_ms(kern), max_abs_err=err, out_sha256=digest,
                lib=str(_build.lib_path("flash_attention")),
                device=torch.cuda.get_device_name(0))


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


def sass(lib: str) -> dict:
    """{tensor-core kernel: its SASS instructions, addresses dropped}, the
    names without the anonymous namespace and with a one-width template
    argument (before PR 28) written as the (DQK, DV) pair."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    kernels, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"^.*?flash_attention_tcILi(\d+)E(?!Li)",
                          r"flash_attention_tcILi\1ELi\1E", m.group(1))
            name = re.sub(r"^.*?(flash_attention_tc)", r"\1", name)
            kernels[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
            if m:
                kernels[name].append(m.group(1))
    return {n: ins for n, ins in kernels.items()
            if n.startswith("flash_attention_tc")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--a", required=True, help="the first tree's root")
    p.add_argument("--b", required=True, help="the second tree's root")
    p.add_argument("--shape", choices=sorted(SHAPES), default="mla")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(child(args.shape, args.seed)),
              flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
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
              f"{res['max_abs_err']:.3e}", flush=True)
    same_out = len({r["out_sha256"] for r in runs}) == 1
    print(f"outputs bit for bit equal across the trees: {same_out}")
    code = {w: sass(next(r for r in runs if r["tree"] == w)["lib"])
            for w in ("a", "b")}
    sass_rows = {}
    for n in sorted(set(code["a"]) | set(code["b"])):
        a, b = code["a"].get(n), code["b"].get(n)
        sass_rows[n] = dict(a=None if a is None else len(a),
                            b=None if b is None else len(b),
                            identical=a == b)
        print(f"SASS {n[:60]}: a {sass_rows[n]['a']}, b {sass_rows[n]['b']} "
              f"instructions, identical {a == b}")
    report = dict(card=card, shape=dict(SHAPES[args.shape], name=args.shape),
                  per=PER, repeats=REPEATS, runs=runs,
                  outputs_equal=same_out, sass=sass_rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
