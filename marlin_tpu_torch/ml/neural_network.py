"""MLP trainer — the reference's NeuralNetwork workload.

Counterpart of ``marlin_tpu/ml/neural_network.py``. The reference trains a
2-layer sigmoid MLP on MNIST with block-sampled mini-batch SGD
(examples/NeuralNetwork.scala): random resident blocks per iteration
(:93-105), a hand-rolled backprop (:119-162) and a ``treeReduce`` of the
per-block gradients (:171-183). The JAX package makes one
jitted step of it (strided row sampling, ``jax.grad``, the update) with the
weights on the device.

Here a step is eager torch on the data's device: the same strided sample
(its offset drawn by the port's threefry ``randint`` on the host — the keys
are two host ints, since on the card each hash round would be a launch —
so the sampled rows equal the JAX package's), ``torch.autograd`` for the
gradients
(``torch.utils.checkpoint`` for ``remat``), and optax's update rules written
out term by term (``sgd``, ``sgd`` with a momentum trace, ``adam``). The
initial weights are the JAX package's threefry ``uniform`` draws, bit for
bit. The losses stay on the device and are read once, at the end of
:meth:`NeuralNetwork.train`, unless ``log_every`` asks for more.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from .. import threefry
from ..config import resolve_device
from ..interop import to_tensor
from ..models.transformer import _adam_update, adam_init
from ..ops.local import precision_scope

__all__ = ["NeuralNetwork", "mlp_init", "mlp_forward", "mlp_loss",
           "train_step", "train_step_optax", "MomentumState"]

_CKPT_ITEM = "ROADMAP queue 1 item 11"

_ACTIVATIONS = {"sigmoid": torch.sigmoid, "relu": torch.relu,
                "tanh": torch.tanh}

_OPTIMIZERS = ("sgd", "momentum", "adam")


class MomentumState(NamedTuple):
    """``optax.trace``'s state: the params-shaped momentum ``trace``."""

    trace: dict


def mlp_init(key, layer_sizes: tuple[int, ...], dtype=torch.float32,
             device=None) -> dict:
    """Glorot-uniform weights ``w0..wN`` — the JAX package's draws bit for
    bit: ``split(key, len(layer_sizes) - 1)``, then one ``uniform`` on
    ``[-limit, limit)`` per layer. ``key`` is an int seed or threefry key
    words; the weights go to ``device`` (default: the key's, or the
    configured one for a seed)."""
    if isinstance(key, torch.Tensor) and device is None:
        device = key.device
    dev = resolve_device(device)
    keys = threefry.split(threefry.as_key(key, dev), len(layer_sizes) - 1)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(layer_sizes[:-1],
                                              layer_sizes[1:])):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        params[f"w{i}"] = threefry.uniform(keys[i], (fan_in, fan_out),
                                           -limit, limit).to(dtype)
    return params


def _activation(activation: str):
    if activation not in _ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; choose from "
            f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[activation]


def mlp_forward(params: dict, x: torch.Tensor,
                activation: str = "sigmoid") -> torch.Tensor:
    """σ(…σ(x·W0)·W1…) — the per-block forward (:221-231), whole-batch.
    ``activation`` applies to hidden layers; the output layer is always
    sigmoid, the reference's output-error convention."""
    act = _activation(activation)
    h = x
    n_layers = len(params)
    for i in range(n_layers):
        z = h @ params[f"w{i}"]
        h = torch.sigmoid(z) if i == n_layers - 1 else act(z)
    return h


def mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor,
             activation: str = "sigmoid") -> torch.Tensor:
    """Squared-error loss matching the reference's output-error convention
    (computeOutputError, examples/NeuralNetwork.scala:119-128)."""
    out = mlp_forward(params, x, activation)
    return 0.5 * torch.mean(torch.sum((out - y) ** 2, dim=-1))


def _sample_indices(key, m: int, batch_size: int, device=None
                    ) -> torch.Tensor:
    """The strided batch on ``device``: a threefry offset in [0, m) drawn on
    the host from ``key`` (host words, or a key tensor, read once), then
    ``batch_size`` rows ``stride`` apart, wrapping — the JAX package's rows
    exactly."""
    stride = max(1, m // batch_size)
    offset = threefry.randint_scalar(key, 0, m)
    steps = torch.arange(batch_size, device=device) * stride
    return (offset + steps) % m


def _sampled_loss_and_grads(params, x, y, key, batch_size, remat, activation):
    """Shared core of both step variants: strided batch sample + grad, with
    TF32 off. Returns the loss (a 0-d tensor) and params-shaped grads."""
    idx = _sample_indices(key, x.shape[0], batch_size, x.device)
    xb, yb = x.index_select(0, idx), y.index_select(0, idx)
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]

    def loss_fn(*ws):
        return mlp_loss(dict(zip(names, ws)), xb, yb, activation)

    with precision_scope("highest"), torch.enable_grad():
        if remat:
            loss = torch.utils.checkpoint.checkpoint(loss_fn, *leaves,
                                                     use_reentrant=False)
        else:
            loss = loss_fn(*leaves)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


@torch.no_grad()
def train_step(params, x, y, key, batch_size: int, lr: float,
               remat: bool = False, activation: str = "sigmoid"):
    """One step: strided batch sample + grad + SGD update (the reference's
    plain update, examples/NeuralNetwork.scala:244-248). ``key`` is a
    threefry key: host words (:func:`~marlin_tpu_torch.threefry.split_words`)
    or a key tensor. ``remat=True``
    recomputes the forward in the backward pass
    (``torch.utils.checkpoint``). Returns ``(new_params, loss)``."""
    loss, grads = _sampled_loss_and_grads(params, x, y, key, batch_size,
                                          remat, activation)
    return {k: params[k] - lr * grads[k] for k in params}, loss


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {optimizer!r} (one of 'sgd', 'momentum', "
            f"'adam')")


def opt_init(optimizer: str, params: dict):
    """The optimizer's zero state — ``optax.<tx>.init(params)``: ``()`` for
    sgd, a zero :class:`MomentumState` for momentum, a zero ``AdamState``
    for adam."""
    _check_optimizer(optimizer)
    if optimizer == "sgd":
        return ()
    if optimizer == "momentum":
        return MomentumState({k: torch.zeros_like(w)
                              for k, w in params.items()})
    return adam_init(params)


@torch.no_grad()
def _apply(optimizer: str, lr: float, momentum: float, params, grads,
           opt_state):
    """optax's update and ``apply_updates``, term by term: sgd
    ``p + (-lr)·g``; momentum ``t = g + μ·t``, ``p + (-lr)·t``; adam as
    ``models.transformer._adam_update``."""
    if optimizer == "sgd":
        return {k: params[k] + (-lr) * grads[k] for k in params}, opt_state
    if optimizer == "momentum":
        trace = {k: grads[k] + momentum * opt_state.trace[k] for k in params}
        return ({k: params[k] + (-lr) * trace[k] for k in params},
                MomentumState(trace))
    return _adam_update(params, grads, opt_state, lr)


def train_step_optax(params, opt_state, x, y, key, batch_size: int,
                     optimizer: str, lr: float, momentum: float = 0.9,
                     remat: bool = False, activation: str = "sigmoid"):
    """The optimizer-parameterized step: optax's momentum/adam rules instead
    of the reference's plain SGD. Same sampling and grad core. Returns
    ``(new_params, new_opt_state, loss)``."""
    _check_optimizer(optimizer)
    loss, grads = _sampled_loss_and_grads(params, x, y, key, batch_size,
                                          remat, activation)
    params, opt_state = _apply(optimizer, lr, momentum, params, grads,
                               opt_state)
    return params, opt_state, loss


@dataclasses.dataclass
class NeuralNetwork:
    """User-facing trainer mirroring the reference CLI's knobs
    (examples/NeuralNetwork.scala:186-208: layer sizes, iterations, step
    size, batch fraction). ``hidden_dim`` may be an int (the reference's two
    layers) or a tuple for arbitrary depth."""

    input_dim: int = 784
    hidden_dim: int | tuple[int, ...] = 100
    output_dim: int = 10
    learning_rate: float = 0.5
    seed: int = 0
    remat: bool = False  # torch.utils.checkpoint the forward
    activation: str = "sigmoid"  # hidden activation; "relu" for deep stacks
    optimizer: str = "sgd"  # "sgd" (reference parity) | "momentum" | "adam"
    momentum: float = 0.9  # used by optimizer="momentum"

    @property
    def layer_sizes(self) -> tuple[int, ...]:
        hidden = ((self.hidden_dim,) if isinstance(self.hidden_dim, int)
                  else tuple(self.hidden_dim))
        return (self.input_dim, *hidden, self.output_dim)

    def init_params(self, mesh=None, dtype=torch.float32) -> dict:
        """Initial weights from ``key(seed)`` on ``mesh``'s device (default:
        the configured one)."""
        dev = mesh.device if mesh is not None else resolve_device(None)
        return mlp_init(threefry.prng_key(self.seed, dev), self.layer_sizes,
                        dtype)

    def train(self, data, labels, iterations: int = 100,
              batch_size: int = 256, params: dict | None = None,
              checkpoint_dir: str | None = None, checkpoint_every: int = 0,
              log_every: int = 0, opt_state=None):
        """Train; ``data`` is a DenseVecMatrix/BlockMatrix (rows = examples)
        or a tensor or array, ``labels`` an (m,) int vector one-hot encoded
        internally (or one-hot rows already). Returns (params, losses).

        With a non-SGD ``optimizer`` the final optimizer state is left on
        ``self.last_opt_state`` and ``opt_state`` resumes from one.
        ``checkpoint_dir`` needs the checkpoint module, which is not ported
        yet: it raises."""
        if checkpoint_dir:
            raise NotImplementedError(
                f"NeuralNetwork.train(checkpoint_dir=...) needs the "
                f"checkpoint module, not ported yet — {_CKPT_ITEM}")
        del checkpoint_every
        if self.optimizer != "sgd":
            _check_optimizer(self.optimizer)
        x = (data.logical() if hasattr(data, "logical")
             else to_tensor(data, device=resolve_device(None)))
        if hasattr(labels, "logical"):
            labels = labels.logical()
        labels = to_tensor(labels, device=x.device)
        y = (torch.nn.functional.one_hot(labels.long(), self.output_dim)
             .to(x.dtype) if labels.ndim == 1 else labels.to(x.dtype))
        if params is None:
            params = mlp_init(threefry.prng_key(self.seed, x.device),
                              self.layer_sizes, x.dtype)
        batch_size = min(batch_size, x.shape[0])
        losses = []
        key = threefry.key_words(self.seed + 1)
        use_optax = self.optimizer != "sgd"
        if use_optax and opt_state is None:
            opt_state = opt_init(self.optimizer, params)
        for it in range(iterations):
            key, sub = threefry.split_words(key)
            if not use_optax:
                params, loss = train_step(
                    params, x, y, sub, batch_size, self.learning_rate,
                    self.remat, self.activation)
            else:
                params, opt_state, loss = train_step_optax(
                    params, opt_state, x, y, sub, batch_size,
                    self.optimizer, self.learning_rate, self.momentum,
                    self.remat, self.activation)
            if log_every and (it + 1) % log_every == 0:
                print(f"iter {it + 1}: loss {float(loss):.6f}")
            losses.append(loss)
        self.last_opt_state = opt_state
        read = torch.stack(losses).cpu().tolist() if losses else []
        return params, [float(v) for v in read]

    def predict(self, params: dict, data) -> np.ndarray:
        w0 = params["w0"]
        x = (data.logical() if hasattr(data, "logical")
             else to_tensor(data, device=w0.device))
        with precision_scope("highest"), torch.no_grad():
            out = mlp_forward(params, x.to(w0.device), self.activation)
        return torch.argmax(out, dim=-1).cpu().numpy()

    def accuracy(self, params: dict, data, labels) -> float:
        pred = self.predict(params, data)
        labels = np.asarray(labels.to_numpy() if hasattr(labels, "to_numpy")
                            else labels)
        return float((pred == labels).mean())

    def save_weights(self, params: dict, path: str):
        """CSV weight dump like the reference's final save
        (examples/NeuralNetwork.scala:259-260)."""
        for name, w in params.items():
            np.savetxt(f"{path}.{name}.csv", w.detach().cpu().numpy(),
                       delimiter=",")
