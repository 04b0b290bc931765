"""repro_torch.guard — the numerical-health word of every solve. The rest
of the JAX package's guard (validation, journal, chaos) comes with a later
slice of the port."""
from .health import (HEALTH_OK, H_MASS_DRIFT, H_MAX_ITER, H_NONFINITE,
                     MASS_TOL, describe_health, health_flags, health_word,
                     rank_mass)

__all__ = ["HEALTH_OK", "H_MAX_ITER", "H_NONFINITE", "H_MASS_DRIFT",
           "MASS_TOL", "health_word", "rank_mass", "health_flags",
           "describe_health"]
