"""repro_torch.train — the JAX package's `repro.train` on one device:
atomic checkpoints of any tree of arrays or tensors (`checkpoint`, JAX's
format), the training loop (`loop.train`, restart-safe, resuming JAX's
checkpoints and JAX resuming its), and the restart loop and elastic
PageRank resume (`elastic`)."""
from .checkpoint import (latest_step, list_checkpoints, restore_checkpoint,
                         save_checkpoint)
from .elastic import RunState, elastic_pagerank_resume, run_with_restarts
from .loop import train

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints", "RunState", "run_with_restarts",
           "elastic_pagerank_resume", "train"]
