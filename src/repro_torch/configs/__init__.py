"""Architecture configs, their registry (the families the port serves) and
the assigned shape set."""
from .base import (ArchConfig, MLACfg, MoECfg, RecCfg, get_config,
                   list_configs, register, smoke_config)
from .shapes import SHAPES, ShapeSpec, cells, shape_applies

__all__ = ["ArchConfig", "MoECfg", "MLACfg", "RecCfg", "get_config",
           "list_configs", "register", "smoke_config", "SHAPES", "ShapeSpec",
           "cells", "shape_applies"]
