"""Model families: the causal transformer LM's serving half and the page
arithmetic of its planner."""

from .planner import kv_page_bytes, request_pages, usable_hbm_bytes  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerLM,
    init_kv_pages,
    init_transformer,
    kv_page_copy,
    lm_decode_paged,
    lm_generate,
    lm_generate_batch,
    lm_prefill_paged,
    resolve_decode_kernel,
)
