"""Model families: the causal transformer LM (training at world size 1 and
serving) and the page arithmetic of its planner."""

from .planner import kv_page_bytes, request_pages, usable_hbm_bytes  # noqa: F401
from .transformer import (  # noqa: F401
    AdamState,
    TransformerLM,
    adam_init,
    init_kv_pages,
    init_transformer,
    kv_page_copy,
    lm_decode_paged,
    lm_generate,
    lm_generate_batch,
    lm_loss,
    lm_prefill_paged,
    lm_train_step,
    lm_value_and_grad,
    resolve_decode_kernel,
    transformer_forward,
)
