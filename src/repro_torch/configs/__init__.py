from repro_torch.configs.registry import (ARCHS, LONG_CONTEXT_OK, PORT_ONLY,
                                          get_config, get_smoke_config,
                                          list_archs)

__all__ = ["ARCHS", "LONG_CONTEXT_OK", "PORT_ONLY", "get_config",
           "get_smoke_config", "list_archs"]
