"""Global configuration for marlin_tpu_torch.

Counterpart of ``marlin_tpu/config.py``: one dataclass with a global instance
and a context manager, holding the knobs this package reads. The JAX package's
``pallas_interpret`` has no meaning here and is dropped: a CUDA kernel has no
interpreter, and a wrapper runs the plain PyTorch version of its kernel only
for tensors that lie on the CPU.

``device`` (new) is where entry points put what they create: ``"cuda"`` by
default, ``"cpu"`` when the caller asks for it. Asking for CUDA on a host
without it raises; nothing falls back to the CPU quietly.

Precision mapping of ``matmul_precision`` (the ``precision=`` argument of the
products that go to ``torch.matmul``), set per call and restored after it:

- ``"highest"`` and ``"high"``: IEEE f32, TF32 off. On the TPU ``"high"`` is
  bf16×3 (relative error ~8e-6); TF32 alone (~1e-3) would be far less exact.
- ``"default"``: TF32 on.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch

# matmul_precision → torch.backends.cuda.matmul.allow_tf32 for that product
TF32_BY_PRECISION = {"highest": False, "high": False, "default": True}


@dataclasses.dataclass
class MarlinConfig:
    # Factorization base block sizes (reference defaults: 1000).
    lu_base_size: int = 1000
    cholesky_base_size: int = 1000
    inverse_base_size: int = 1000
    # Size threshold (matrix dim) up to which factorizations take the local
    # path ("breeze" mode in the reference, DenseVecMatrix.scala:289-298 uses
    # n > 6000 for its distributed one).
    local_fallback_dim: int = 6000
    # Broadcast-multiply threshold in MB (DenseVecMatrix.scala:196-198 default 300).
    broadcast_threshold_mb: float = 300.0
    # Default element dtype for matrices.
    default_dtype: Any = torch.float32
    # Precision of the products on the hot path (see the module docstring).
    matmul_precision: str = "highest"
    # SVD mode thresholds (DenseVecMatrix.scala:1569-1588).
    svd_local_dim: int = 2000
    # Lanczos iterations multiplier for dist-eigs SVD.
    lanczos_max_iter_factor: int = 10
    # Where the autotune winners persist across processes. None =
    # build/marlin_tpu_torch/autotune.json at the repository root; "" disables
    # the disk layer (in-process caching still works).
    autotune_cache_path: str | None = None
    # Device entry points create their tensors on: "cuda" or "cpu".
    device: str = "cuda"


_config = MarlinConfig()


def get_config() -> MarlinConfig:
    return _config


def set_config(**kwargs: Any) -> MarlinConfig:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown marlin_tpu_torch config key: {k}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def config_context(**kwargs: Any) -> Iterator[MarlinConfig]:
    old = {k: getattr(_config, k) for k in kwargs}
    try:
        set_config(**kwargs)
        yield _config
    finally:
        set_config(**old)


def resolve_device(device=None) -> torch.device:
    """``device`` or the configured one, as a ``torch.device``. Raises when
    CUDA is asked for and this host has none."""
    dev = torch.device(device if device is not None else _config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "marlin_tpu_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' or use config_context(device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def tf32_for(precision: str) -> bool:
    """Whether a product at ``precision`` may use TF32."""
    try:
        return TF32_BY_PRECISION[precision]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {precision!r} (one of "
            f"{tuple(TF32_BY_PRECISION)})") from None
