"""Dense transformer of the port with HBFP dot products."""
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import (decode_step, from_jax_params,
                                            init_params, lane_capacity,
                                            make_cache, make_paged_cache,
                                            prefill)

__all__ = ["Ctx", "KVCache", "PagedKVCache", "decode_step",
           "from_jax_params", "init_params", "lane_capacity", "make_cache",
           "make_paged_cache", "prefill"]
