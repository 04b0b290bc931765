"""Hand-written CUDA kernels (sm_90a) for the fused and the staged rank
sweeps, the streaming snapshot's row scatter and the LM's prefill
attention, each beside its plain PyTorch version.

A wrapper runs the plain version on CPU tensors and launches its kernel on
CUDA tensors (or raises); each keeps a launch count in `<wrapper>.launches`.
The kernels are built from `csrc/` by `_build` on first use.
"""
from .csr_block import csr_block_pull
from .ell_bucket_pull import ell_bucket_pull, fused_ell_update
from .ell_pull import ell_pull, ell_pull_buckets
from .flash_attn import flash_attention, flash_attention_bshd
from .linf_delta import linf_delta
from .ops import pull_sum_kernels, update_ranks_kernel
from .pr_update import pr_update, pr_update_sweep
from .stream_scatter import ell_scatter_rows, scatter_rows

__all__ = ["fused_ell_update", "csr_block_pull", "pr_update",
           "pr_update_sweep", "update_ranks_kernel", "scatter_rows",
           "ell_scatter_rows", "ell_pull", "ell_pull_buckets",
           "ell_bucket_pull", "linf_delta", "pull_sum_kernels",
           "flash_attention", "flash_attention_bshd"]
