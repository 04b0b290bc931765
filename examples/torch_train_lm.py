"""Train a small LM for a few hundred steps with checkpointing, on the
PyTorch port (`repro_torch`): the counterpart of examples/train_lm.py.

Uses the smollm-360m *architecture* at reduced width (its smoke config, a
few M parameters; pass --full-width for the real 360M config on a card).
On CUDA unless --device names another:

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu [--steps 200]
"""
import argparse
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.train import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--full-width", action="store_true")
ap.add_argument("--device", default=None, help="torch device (default: cuda)")
args = ap.parse_args()

cfg = get_config("smollm-360m")
if not args.full_width:
    cfg = smoke_config(cfg)
with tempfile.TemporaryDirectory() as ckpt:
    params, history = train(cfg, steps=args.steps, batch=4, seq=128,
                            ckpt_dir=ckpt, ckpt_every=100, log_every=20,
                            device=args.device)
first, last = history[0], history[-1]
print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} over "
      f"{last['step']} steps ({last['sec']:.0f}s)")
assert last["loss"] < first["loss"], "loss should decrease"
