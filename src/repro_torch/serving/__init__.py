"""repro_torch.serving — continuous batching engine + prefix cache controller."""

from repro_torch.serving.engine import Engine, Request, ServeConfig
from repro_torch.serving.kv_pages import PageAllocator
from repro_torch.serving.prefix_cache import PrefixCache, chunk_hashes

__all__ = ["Engine", "PageAllocator", "PrefixCache", "Request", "ServeConfig",
           "chunk_hashes"]
