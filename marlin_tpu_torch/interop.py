"""Carry state across from the JAX package.

The JAX package hands its state out as numpy arrays (``to_numpy()`` of its
matrices and vectors); this module turns such arrays into the port's tensors
and matrices on the port's device, keeping the dtype — bf16 included, which
numpy holds as the ``ml_dtypes`` type ``bfloat16`` and torch cannot read
directly. :func:`lm_params_from_numpy` carries the transformer LM's
parameters across, so that both packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import resolve_device


def torch_dtype(dtype: Any) -> torch.dtype | None:
    """A torch dtype for a torch dtype, a numpy dtype or a name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def to_tensor(arr, dtype: Any = None, device=None) -> torch.Tensor:
    """``arr`` (a tensor, a numpy array — bf16 included — or anything numpy
    reads) as a tensor on ``device`` (default: the configured one), cast to
    ``dtype`` when given. A tensor already there in that dtype is returned
    as it is."""
    dev = resolve_device(device) if device is not None or \
        not isinstance(arr, torch.Tensor) else arr.device
    if not isinstance(arr, torch.Tensor):
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            arr = torch.from_numpy(
                np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(np.ascontiguousarray(a))
    return arr.to(device=dev, dtype=torch_dtype(dtype) or arr.dtype)


_KINDS = ("DenseVecMatrix", "BlockMatrix", "DenseMatrix", "DistributedVector",
          "DistributedIntVector")


def matrices_from_numpy(arrays: dict[str, np.ndarray],
                        kind: str = "DenseVecMatrix",
                        device=None) -> dict[str, Any]:
    """Turn the JAX package's matrices, as ``to_numpy()`` gives them, into the
    port's: ``{name: array}`` → ``{name: <kind>}`` on ``device``, dtype kept.
    ``kind`` names the port's class: a matrix class for 2-D arrays, a vector
    class for 1-D ones."""
    from . import matrix
    from .mesh import create_mesh

    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r} (one of {_KINDS})")
    klass = getattr(matrix, kind)
    mesh = create_mesh(device=device)
    want = 1 if "Vector" in kind else 2
    out = {}
    for name, arr in arrays.items():
        if np.ndim(arr) != want:
            raise ValueError(f"{name}: a {kind} needs a {want}-D array, got "
                             f"shape {np.shape(arr)}")
        out[name] = klass.from_array(to_tensor(arr, device=mesh.device), mesh)
    return out


_LM_LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1", "ln2", "w1", "w2")


def lm_params_from_numpy(params_np: dict, device=None, dtype: Any = None
                         ) -> dict:
    """The JAX package's transformer params (``emb``, ``l{i}`` with
    ``wq, wk, wv, wo, ln1, ln2, w1, w2``, ``ln_f``; numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's params dict, 1:1, on
    ``device`` (default: the configured one), in ``dtype`` when given, else
    each array's own. Raises on a key the port does not know (MoE layers)."""
    out = {}
    for name, value in params_np.items():
        if name in ("emb", "ln_f"):
            out[name] = to_tensor(np.array(value), dtype, device)
        elif name.startswith("l") and name[1:].isdigit():
            extra = set(value) - set(_LM_LAYER_KEYS)
            if extra:
                raise NotImplementedError(
                    f"{name}: parameters {sorted(extra)} have no counterpart "
                    f"in the port (mixture-of-experts layers: ROADMAP queue "
                    f"10)")
            out[name] = {k: to_tensor(np.array(value[k]), dtype, device)
                         for k in _LM_LAYER_KEYS}
        else:
            raise ValueError(f"unknown transformer parameter {name!r}")
    return out
