"""gemma2-9b's training step at several depths and allocator settings.

Runs chip_smoke.py's 13c (`gemma_train_run`: `train` at full width, bf16,
AdamW, 3 steps on 1 x 8192, then one step split by CUDA events and one
under torch.profiler) once for each depth and each setting of the CUDA
caching allocator's expandable segments, each in a fresh process that sets
PYTORCH_CUDA_ALLOC_CONF before CUDA starts. It reports, per run, the step
times, the peak allocated and reserved memory, the allocator's retries and
device allocations over the steps and over the split step, the split, and
the device's busy time; a run that runs out of memory reports where. Needs
one CUDA card:

    python3 scripts/gemma_train_memory.py --layers 2 4 --out FILE.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(layers: int) -> dict:
    """One run, in the process whose allocator the environment set."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke

    args = chip_smoke.parse_args([])
    dev = torch.device("cuda")
    try:
        rep, _, model, opt = chip_smoke.gemma_train_run(args, dev, layers)
        del model, opt
    except torch.OutOfMemoryError as exc:
        rep = dict(layers=layers, oom=str(exc).splitlines()[0][:400],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   alloc=chip_smoke.alloc_counts())
    rep["total_bytes"] = torch.cuda.get_device_properties(0).total_memory
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    p.add_argument("--out", default=None)
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        print("RESULT " + json.dumps(child(args.child)), flush=True)
        return 0
    runs, rc = [], 0
    for layers in args.layers:
        for on in (False, True):
            conf = f"expandable_segments:{'True' if on else 'False'}"
            env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=conf)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(layers)], env=env, cwd=ROOT, capture_output=True,
                text=True)
            print(proc.stdout[-6000:], flush=True)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if proc.returncode or not line:
                print(proc.stderr[-4000:], file=sys.stderr)
                rc = 1
                continue
            res = json.loads(line[-1][len("RESULT "):])
            res["conf"] = conf
            runs.append(res)
            print(f"{layers} layers, {conf}: " + (
                f"out of memory ({res['oom']})" if "oom" in res else
                "steps " + " / ".join(f"{1e3 * x:.1f}" for x in res["step_s"])
                + f" ms, split step wall {res['breakdown']['wall_ms']:.1f} "
                f"ms") + f"; peak allocated "
                f"{res['peak_mem_bytes'] / 2**30:.3f} GiB, reserved "
                f"{res['peak_reserved_bytes'] / 2**30:.3f} GiB", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(runs=runs), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
