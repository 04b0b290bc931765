"""repro_torch.train — the part of the JAX package's `repro.train` the
port has so far: atomic checkpoints of flat array dicts (`checkpoint`),
which the guard's session checkpoints sit on, and the restart loop and
elastic PageRank resume (`elastic`). The training loop and model trees
come with ROADMAP A9."""
from .checkpoint import (latest_step, list_checkpoints, restore_checkpoint,
                         save_checkpoint)
from .elastic import RunState, elastic_pagerank_resume, run_with_restarts

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints", "RunState", "run_with_restarts",
           "elastic_pagerank_resume"]
