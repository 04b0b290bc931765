"""Architecture configs and their registry (the families the port serves)."""
from .base import (ArchConfig, MLACfg, MoECfg, RecCfg, get_config,
                   list_configs, register, smoke_config)

__all__ = ["ArchConfig", "MoECfg", "MLACfg", "RecCfg", "get_config",
           "list_configs", "register", "smoke_config"]
