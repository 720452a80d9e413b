"""Model families (canonical namespace).

The reference's "models" are workloads built from its matrix primitives: a
2-layer MLP, logistic regression, PageRank and ALS matrix factorization,
implemented in :mod:`marlin_tpu_torch.ml` and re-exported here (resolved
at first use: ``ml`` imports the trainer's Adam from this package). The
causal transformer LM (training, serving), its mixture-of-experts FFN,
DeepSeek-V2's latent attention and DeepSeekMoE on its trainer, the
pipeline-parallel LM and the memory planner complete it.
"""

import importlib

_ML = {"ALSModel": "als", "als_run": "als",
       "LogisticRegressionModel": "logistic_regression",
       "logistic_regression": "logistic_regression",
       "NeuralNetwork": "neural_network", "mlp_forward": "neural_network",
       "mlp_init": "neural_network", "train_step": "neural_network",
       "build_transition_matrix": "pagerank", "pagerank": "pagerank"}


def __getattr__(name):
    if name in _ML:
        mod = importlib.import_module(f"..ml.{_ML[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_ML))

from .deepseek import DeepSeekConfig, init_deepseek  # noqa: F401
from .moe import init_moe, moe_ffn, shard_moe_params  # noqa: F401
from .pipeline_lm import pp_lm_loss, pp_lm_train_step, pp_stage_params  # noqa: F401
from .planner import (  # noqa: F401
    ContextPlan,
    kv_page_bytes,
    plan_context,
    request_pages,
    usable_hbm_bytes,
)
from .transformer import (  # noqa: F401
    AdamState,
    TransformerLM,
    adam_init,
    init_kv_pages,
    init_kv_slab,
    init_transformer,
    kv_page_copy,
    lm_decode_paged,
    lm_decode_rows,
    lm_generate,
    lm_generate_batch,
    lm_loss,
    lm_prefill_paged,
    lm_prefill_slot,
    lm_train_step,
    lm_value_and_grad,
    resolve_decode_kernel,
    transformer_forward,
)
