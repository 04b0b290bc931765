"""repro_torch: the PyTorch + CUDA port of `repro` (Static and DF-P
PageRank, Sahu 2024, and the repo's LM substrate) for one NVIDIA H100.

Plain tensor code is PyTorch; the rank sweep, the streaming snapshot's
row edits (`stream/`) and the LM's attention (`models/`: the prefill's and
training's forward, and training's backward) run hand-written CUDA kernels
(`kernels/`, sources in `csrc/`) on CUDA tensors and their plain PyTorch
versions on CPU tensors. `optim/` and `train/loop.py` train the LM. `guard/` keeps a stream
session healthy (validation, the health word's escalation ladder, a drift
audit) and recoverable (a CRC delta journal and atomic checkpoints,
`train/checkpoint.py`). Staging functions put
tensors on CUDA unless the caller passes `device=` (`device.py`). Nothing
here imports JAX or `repro`.
"""
__version__ = "0.1.0"
