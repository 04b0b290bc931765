"""repro_torch: the PyTorch + CUDA port of `repro` (Static and DF-P
PageRank, Sahu 2024) for one NVIDIA H100.

Plain tensor code is PyTorch; the rank sweep and the streaming snapshot's
row edits (`stream/`) run hand-written CUDA kernels (`kernels/`, sources
in `csrc/`) on CUDA tensors and their plain PyTorch versions on CPU
tensors. Staging functions put tensors on CUDA unless the caller passes
`device=`. Nothing here imports JAX or `repro`.
"""
__version__ = "0.1.0"
