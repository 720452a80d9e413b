"""Carry state across from the JAX package.

The JAX package hands its state out as numpy arrays (``to_numpy()`` of its
matrices and vectors); this module turns such arrays into the port's tensors
and matrices on the port's device, keeping the dtype — bf16 included, which
numpy holds as the ``ml_dtypes`` type ``bfloat16`` and torch cannot read
directly. :func:`lm_params_from_numpy` carries the transformer LM's
parameters across, so that both packages compute with the same weights, and
:func:`adam_state_from_numpy` its ``optax.adam`` state, so that training
resumes where the JAX package left it. The ML workloads' state crosses
too: :func:`mlp_params_from_numpy` and :func:`mlp_opt_state_from_numpy` (the
MLP's ``w0..wN`` and its optax state), :func:`als_model_from_numpy` (the two
factor matrices of an ``ALSModel``). The sparse matrices cross as their
arrays: :func:`bsr_from_numpy` (a ``BsrMatrix``),
:func:`sparse_vec_matrix_from_numpy` (a ``SparseVecMatrix`` from its BCOO's
``indices``/``data``) and :func:`coordinate_matrix_from_numpy`.
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


def to_host(x) -> tuple[np.ndarray, torch.dtype | None]:
    """``x`` as a numpy array on the host, and the torch dtype to give it back
    on the device: a bf16 tensor comes back as float32 (numpy has no bf16 of
    its own) with ``torch.bfloat16``; anything else keeps its dtype (None)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.float().numpy(), torch.bfloat16
    return x.numpy(), None


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
                    f"1 item 12)")
            out[name] = {k: to_tensor(np.array(value[k]), dtype, device)
                         for k in _LM_LAYER_KEYS}
        else:
            raise ValueError(f"unknown transformer parameter {name!r}")
    return out


def adam_state_from_numpy(state, device=None):
    """An ``optax.adam`` state of the JAX package's transformer as the port's
    :class:`~marlin_tpu_torch.models.transformer.AdamState`, so that a run
    resumed from JAX params and optimizer state takes the same next step.
    ``state`` is ``(count, mu, nu)`` as numpy (``mu``/``nu`` params-shaped),
    or the optax state itself through ``jax.tree.map(np.asarray, ...)``: the
    ``ScaleByAdamState`` or the chain tuple that holds it first. The moments
    go to ``device`` (default: the configured one) as f32."""
    from .models.transformer import AdamState

    if isinstance(state, tuple) and not hasattr(state, "mu") and state \
            and hasattr(state[0], "mu"):
        state = state[0]  # optax.adam = chain(scale_by_adam, scale_by_lr)
    if hasattr(state, "mu"):
        state = (state.count, state.mu, state.nu)
    count, mu, nu = state
    return AdamState(int(np.asarray(count)),
                     lm_params_from_numpy(mu, device, np.float32),
                     lm_params_from_numpy(nu, device, np.float32))


def mlp_params_from_numpy(params_np: dict, device=None, dtype: Any = None
                          ) -> dict:
    """The JAX package's MLP params (``w0..wN``, numpy, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's dict on ``device``
    (default: the configured one), in ``dtype`` when given. Raises on any
    other key."""
    for i in range(len(params_np)):
        if f"w{i}" not in params_np:
            raise ValueError(f"MLP params must be w0..w{len(params_np) - 1}, "
                             f"got {sorted(params_np)}")
    return {f"w{i}": to_tensor(np.array(params_np[f"w{i}"]), dtype, device)
            for i in range(len(params_np))}


def mlp_opt_state_from_numpy(state, device=None):
    """An optax state of the JAX package's MLP trainer (``jax.tree.map(
    np.asarray, state)``) as the port's, so that
    ``train_step_optax``/``NeuralNetwork.train(opt_state=...)`` resume where
    the JAX package left off: ``optax.sgd``'s empty state as ``()``, its
    momentum ``TraceState`` as ``MomentumState``, ``optax.adam``'s
    ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) as ``AdamState``. The
    chain tuple optax returns is read through its first element."""
    from .ml.neural_network import MomentumState
    from .models.transformer import AdamState

    if isinstance(state, tuple) and not hasattr(state, "_fields") and state:
        state = state[0]  # chain(<rule>, scale_by_learning_rate)
    if hasattr(state, "mu"):
        return AdamState(int(np.asarray(state.count)),
                         mlp_params_from_numpy(state.mu, device, np.float32),
                         mlp_params_from_numpy(state.nu, device, np.float32))
    if hasattr(state, "trace"):
        return MomentumState(mlp_params_from_numpy(state.trace, device))
    if getattr(state, "_fields", None) == () or state == ():
        return ()
    raise ValueError(f"not an optax sgd/momentum/adam state: {state!r}")


def als_model_from_numpy(user_features, product_features, device=None):
    """The JAX package's ``ALSModel``, as its two factor matrices
    (``to_numpy()``), as the port's ``ALSModel`` on ``device`` (default: the
    configured one)."""
    from .matrix.dense import DenseVecMatrix
    from .mesh import create_mesh
    from .ml.als import ALSModel

    mesh = create_mesh(device=device)
    return ALSModel(*(DenseVecMatrix.from_array(
        to_tensor(np.array(f), device=mesh.device), mesh)
        for f in (user_features, product_features)))


def bsr_from_numpy(blocks, block_rows, block_cols, shape, block_size: int,
                   device=None):
    """The JAX package's ``BsrMatrix`` (its ``blocks``, ``block_rows``,
    ``block_cols`` as numpy, its ``shape`` and ``block_size``) as the port's,
    on ``device`` (default: the configured one)."""
    from .ops.sparse_bsr import BsrMatrix

    dev = resolve_device(device)
    return BsrMatrix(to_tensor(np.asarray(blocks), device=dev),
                     to_tensor(np.asarray(block_rows), torch.int32, dev),
                     to_tensor(np.asarray(block_cols), torch.int32, dev),
                     shape, block_size)


def sparse_vec_matrix_from_numpy(indices, data, shape, device=None):
    """The JAX package's ``SparseVecMatrix`` from its BCOO's ``indices``
    ``(nse, 2)`` and ``data`` ``(nse,)`` as numpy, on ``device`` (default: the
    configured one). BCOO padding entries (an index equal to the dimension)
    are dropped; duplicates are summed."""
    from .matrix.sparse import SparseVecMatrix
    from .mesh import create_mesh

    idx = np.asarray(indices).astype(np.int64)
    data = np.asarray(data)
    keep = (idx[:, 0] < shape[0]) & (idx[:, 1] < shape[1])
    mesh = create_mesh(device=device)
    coo = torch.sparse_coo_tensor(to_tensor(idx[keep].T, device=mesh.device),
                                  to_tensor(data[keep], device=mesh.device),
                                  tuple(shape), check_invariants=True)
    return SparseVecMatrix(coo, tuple(shape), mesh)


def coordinate_matrix_from_numpy(rows, cols, vals, shape, device=None):
    """The JAX package's ``CoordinateMatrix`` from its (rows, cols, vals)
    (``triplets()``) as numpy, on ``device`` (default: the configured one)."""
    from .matrix.sparse import CoordinateMatrix
    from .mesh import create_mesh

    return CoordinateMatrix(np.asarray(rows), np.asarray(cols),
                            np.asarray(vals), shape=shape,
                            mesh=create_mesh(device=device))
