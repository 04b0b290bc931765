"""repro_torch.guard — the numerical-health word of every solve and the
ingest validation gate. The rest of the JAX package's guard (journal,
chaos, the session's escalation ladder) comes with a later slice of the
port."""
from .health import (HEALTH_OK, H_MASS_DRIFT, H_MAX_ITER, H_NONFINITE,
                     MASS_TOL, describe_health, health_flags, health_word,
                     rank_mass)
from .validate import (POLICIES, QuarantineReport, ValidationError,
                       validate_batch)

__all__ = ["HEALTH_OK", "H_MAX_ITER", "H_NONFINITE", "H_MASS_DRIFT",
           "MASS_TOL", "health_word", "rank_mass", "health_flags",
           "describe_health", "POLICIES", "QuarantineReport",
           "ValidationError", "validate_batch"]
