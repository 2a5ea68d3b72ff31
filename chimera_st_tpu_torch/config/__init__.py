from .registry import REGISTRIES, Registry, get_registry

__all__ = ["Registry", "REGISTRIES", "get_registry"]
