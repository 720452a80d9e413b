"""Batched classification scoring as a BucketProgram.

Counterpart of ``marlin_tpu/serving/programs/classify.py``. Serves either of
the supervised models online: a
:class:`~marlin_tpu_torch.ml.logistic_regression.LogisticRegressionModel`
(intercept-first weight vector) or an MLP parameter dict from
:func:`~marlin_tpu_torch.ml.neural_network.mlp_init` — a request carries one
feature vector (payload ``{"x": (d,) floats}``) and gets back the model's
probabilities plus an argmax/threshold label. One program bucket (the model
is the shape), padded batch widths shared with every other program, and the
same atomic :meth:`ClassifyProgram.swap_model` contract as ALS.

The JAX package checks an MLP's ``w0..wN`` keys and its activation at
construction with ``jax.eval_shape``; here both are checked eagerly, with
the same ``ValueError``s, and one forward of a zero row checks the layer
shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...interop import to_tensor
from ...ml.neural_network import mlp_forward
from ...obs import perf
from ...ops.local import precision_scope
from . import register_program
from .base import BucketProgram

__all__ = ["ClassifyProgram"]


def _logreg_proba(weights, x):
    return torch.sigmoid(weights[0] + x @ weights[1:])


def _model_arrays(model, activation):
    """(kind, params, feature_dim, num_outputs) for either model family.
    Tensors keep their device; arrays go to the configured one."""
    w = getattr(model, "weights", model)
    if isinstance(w, dict):
        dev = next((v.device for v in w.values()
                    if isinstance(v, torch.Tensor)), None) \
            or resolve_device(None)
        params = {k: to_tensor(v, torch.float32, dev) for k, v in w.items()}
        for i in range(len(params)):
            if f"w{i}" not in params:
                raise ValueError(
                    f"MLP params must be w0..w{len(params) - 1}, got "
                    f"{sorted(params)}")
        dim = int(params["w0"].shape[0])
        n_out = int(params[f"w{len(params) - 1}"].shape[1])
        # rejects an unknown activation or mismatched layers now, not in
        # the worker's first step
        with torch.no_grad(), precision_scope("highest"):
            mlp_forward(params, torch.zeros((1, dim), device=dev), activation)
        return "mlp", params, dim, n_out
    dev = w.device if isinstance(w, torch.Tensor) else resolve_device(None)
    w = to_tensor(w, torch.float32, dev).reshape(-1)
    if w.shape[0] < 2:
        raise ValueError(f"logreg weights need [intercept, w...], got "
                         f"shape {tuple(w.shape)}")
    return "logreg", w, int(w.shape[0]) - 1, 1


@register_program
class ClassifyProgram(BucketProgram):
    """feature vector → class probabilities over a resident model."""

    name = "classify"
    cost_program = "classify_fwd"
    resource_unit = "one padded feature row: feature_dim x 4 bytes"

    def __init__(self, model, activation: str = "sigmoid"):
        super().__init__()
        self._activation = activation
        self._kind, self._params, self.feature_dim, self.num_outputs = \
            _model_arrays(model, activation)
        self.swap_count = 0
        self._ledger_register(self._params)

    def swap_model(self, model) -> None:
        """Atomically install new weights of the same shape."""
        kind, params, dim, n_out = _model_arrays(model, self._activation)
        if (kind, dim, n_out) != (self._kind, self.feature_dim,
                                  self.num_outputs):
            raise ValueError(
                f"swap_model shape mismatch: resident {self._kind} "
                f"d={self.feature_dim} out={self.num_outputs}, new {kind} "
                f"d={dim} out={n_out}")
        with self._lock:
            self._params = params
            self.swap_count += 1
        self._ledger_register(self._params)

    @property
    def _device(self):
        p = self._params
        return (p["w0"] if isinstance(p, dict) else p).device

    # ---------------------------------------------------------------- policy
    def buckets(self):
        return [()]  # the model is the shape; width is the only batch axis

    def validate(self, request):
        p = request.payload
        x = p.get("x") if isinstance(p, dict) else p
        if x is None:
            return (f"program {self.name!r} needs payload "
                    f"{{'x': ({self.feature_dim},) floats}}")
        x = np.asarray(x, np.float32).reshape(-1)
        if x.shape[0] != self.feature_dim:
            return (f"feature vector has {x.shape[0]} dims, model wants "
                    f"{self.feature_dim}")
        return None

    def pick_bucket(self, request):
        return ()

    def admission_cost(self, request, bucket):
        return self.feature_dim * 4

    def program_key(self, bucket, width=None):
        return perf.program_key(
            prog=self.name, kind=self._kind, dim=self.feature_dim,
            out=self.num_outputs, width=width or self.width)

    def _cost(self, w: int) -> dict:
        """Analytic cost of one forward: the layer products' FLOPs; the
        features, weights and outputs moved."""
        p = self._params
        mats = list(p.values()) if isinstance(p, dict) else [p]
        weights = sum(int(m.numel()) for m in mats)
        return {"flops": 2.0 * w * weights,
                "bytes accessed": 4.0 * (w * self.feature_dim + weights
                                         + w * self.num_outputs)}

    # ------------------------------------------------------------- mechanism
    def _fwd(self, params, x):
        with torch.no_grad(), precision_scope("highest"):
            if self._kind == "logreg":
                return _logreg_proba(params, x)
            return mlp_forward(params, x, self._activation)

    def warmup(self) -> int:
        """One forward per padded width, and its cost record."""
        n = 0
        with self._lock:
            params = self._params
        for w in self.widths:
            self._capture_cost(self.program_key((), w), self._cost(w))
            self._fwd(params, torch.zeros((w, self.feature_dim),
                                          device=self._device))
            n += 1
        return n

    def step(self, bucket, requests):
        w = self.step_width(len(requests))
        x = np.zeros((w, self.feature_dim), np.float32)
        for i, r in enumerate(requests):
            p = r.payload
            x[i] = np.asarray(p.get("x") if isinstance(p, dict) else p,
                              np.float32).reshape(-1)
        with self._lock:
            params = self._params
        # the one read of the card per program step
        proba = self._fwd(params, torch.from_numpy(x).to(self._device)) \
            .cpu().numpy()
        out = []
        for i, _ in enumerate(requests):
            row = proba[i]
            if row.ndim == 0 or (row.ndim == 1 and row.shape[0] == 1):
                p1 = float(np.reshape(row, ()) if row.ndim == 0 else row[0])
                out.append({"proba": p1, "label": int(p1 >= 0.5)})
            else:
                out.append({"proba": row.copy(),
                            "label": int(np.argmax(row))})
        return out
