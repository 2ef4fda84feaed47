"""Serving plane of the port: disaggregated prefill/insert/generate stages,
a paged BFP KV cache and per-request sampling (DESIGN.md §14)."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_cache import (PagePool, clear_pages,
                                           insert_prefix, pages_needed,
                                           set_page_table)
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_tokens

__all__ = ["GREEDY", "PagePool", "SamplingParams", "ServeEngine",
           "clear_pages", "insert_prefix", "pages_needed", "sample_tokens",
           "set_page_table"]
