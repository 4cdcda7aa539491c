"""Weights across the two frameworks.

The JAX package's parameters are a flat ``{layer: {var: array}}`` tree
(``ts.params`` of a trainer, as numpy arrays), and its non-trainable state
(the spectral-norm ``u`` vectors, ``ts.state``) a second tree of the same
form.  The port keeps the same scope names and layouts
(``rcgan_tpu_torch/core/module.py``), parameters as ``nn.Parameter``
objects and state as buffers, so moving both trees either way is a copy by
name: a round trip is bit-exact.

A whole train state crosses too (:func:`train_state_from_jax` for CIFAR,
:func:`mnist_train_state_from_jax` for MNIST,
:func:`pggan_train_state_from_jax` for PGGAN, :func:`to_jax_train_state`
for all three): the parameter groups, the state (the SN ``u`` vectors, and
the BN ``moving_mean``/``moving_variance`` of MNIST and of the PGGAN critic,
with its ``biased_mean``/``local_step``), each group's Adam
``count``/``mu``/``nu`` and ``step``, laid out as the JAX ``TrainState``
with its optax states ``(ScaleByAdamState(count, mu, nu), EmptyState())``.

On disk a tree is one ``.npz`` whose keys are ``"<layer>/<var>"``
(``G.Block.1.Conv1/Filters``); ``scripts/export_generator_npz.py`` writes
the generator's from a JAX checkpoint as ``generator.npz``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
from rcgan_tpu_torch.core.module import param_tree, scoped_modules, state_tree
from rcgan_tpu_torch.models.dcgan import DCGANConfig
from rcgan_tpu_torch.models.pggan import PGGANConfig
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig
from rcgan_tpu_torch.train import mnist_loop, pggan_loop
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, new_train_state
from rcgan_tpu_torch.train.state import TrainState

NpTree = Dict[str, Dict[str, np.ndarray]]


def load_tree(module: nn.Module, params: Mapping, state: Optional[Mapping] = None,
              prefix: str = "G.") -> nn.Module:
    """Copy ``params`` (and ``state``) into ``module``'s parameters (and
    buffers) by scope and var name.  Layers outside ``prefix`` are ignored
    (a trainer's tree also holds D and C); within it, every layer and var
    must match the module's exactly, in name and shape.  Parameters are
    copied in place; state buffers are rebound to new tensors, so a view
    taken before (``state_tree``) keeps its values."""
    state = {} if state is None else state
    mods = scoped_modules(module)
    for kind, tree, own in (("param", params, param_tree(module)),
                            ("state", state, state_tree(module))):
        theirs = {k for k in tree if k.startswith(prefix)}
        mine = {k for k in own if k.startswith(prefix)}
        if theirs != mine:
            raise KeyError(f"{kind} layers differ: missing {sorted(mine - theirs)}, "
                           f"unexpected {sorted(theirs - mine)}")
        for layer in sorted(mine):
            if set(tree[layer]) != set(own[layer]):
                raise KeyError(f"{kind} vars of {layer} differ: {sorted(tree[layer])} vs "
                               f"{sorted(own[layer])}")
            for var, dst in own[layer].items():
                src = torch.from_numpy(np.array(tree[layer][var]))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{layer}/{var}: shape {tuple(src.shape)}, "
                                     f"module wants {tuple(dst.shape)}")
                if kind == "state":  # rebound, as the SN update writes state
                    setattr(mods[layer], var, src.to(dst.device, dst.dtype).clone())
                else:
                    with torch.no_grad():
                        getattr(mods[layer], var).copy_(src.to(dst.dtype))
    return module


def generator_from_jax(params: Mapping, cfg: ResnetGANConfig = ResnetGANConfig(),
                       device="cuda", state: Optional[Mapping] = None) -> Generator:
    """The port's generator holding the JAX tree's ``G.*`` weights.  The
    generator has no state (cond-BN keeps no running stats), so ``state``
    may hold no ``G.*`` layer."""
    return load_tree(Generator(cfg, device=device), params, state)


def gan_from_jax(params: Mapping, state: Optional[Mapping],
                 cfg: ResnetGANConfig = ResnetGANConfig(),
                 acfg: CifarAlgoConfig = CifarAlgoConfig(), device="cuda") -> CifarGAN:
    """The port's :class:`CifarGAN` holding a whole trainer tree: every
    ``G.*``, ``D.*`` and ``confusion_logits`` parameter and every SN ``u``.
    The trees must match the model that ``cfg``/``acfg`` build exactly."""
    return load_tree(CifarGAN(cfg, acfg, device=device), params, state, prefix="")


def _np_tree(tree) -> NpTree:
    return {layer: {var: t.cpu().numpy().copy() for var, t in d.items()}
            for layer, d in tree.items()}


def to_jax_tree(module: nn.Module):
    """``(params, state)``: the module's parameters and buffers as JAX-layout
    numpy trees (``state`` is empty for a module without SN)."""
    return _np_tree(param_tree(module)), _np_tree(state_tree(module))


def save_npz(path: str, tree: Mapping) -> None:
    """Write a ``{layer: {var: array}}`` tree as ``layer/var`` keys."""
    flat = {f"{layer}/{var}": np.asarray(a) for layer, d in tree.items() for var, a in d.items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> NpTree:
    tree: NpTree = {}
    with np.load(path) as data:
        for key in data.files:
            layer, var = key.rsplit("/", 1)
            tree.setdefault(layer, {})[var] = data[key]
    return tree


class AdamMoments(NamedTuple):
    """The fields of optax's ``ScaleByAdamState``, as numpy."""
    count: Any
    mu: NpTree
    nu: NpTree


class NumpyTrainState(NamedTuple):
    """A train state as numpy, in the layout of the JAX ``TrainState``:
    ``opt_states[group]`` is ``(AdamMoments, ())`` where JAX holds
    ``(ScaleByAdamState, EmptyState())``."""
    groups: Dict[str, NpTree]
    state: NpTree
    opt_states: Dict[str, tuple]
    step: Any


def _by_key(tree: Mapping, keys) -> list:
    return [np.asarray(tree[layer][var]) for layer, var in keys]


def train_state_from_jax(ts_numpy, cfg: ResnetGANConfig, acfg: CifarAlgoConfig,
                         tcfg: CifarTrainConfig, device="cuda",
                         compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """The port's CIFAR :class:`TrainState` from a JAX ``TrainState`` whose
    leaves are numpy arrays (or a :class:`NumpyTrainState`): every group's
    parameters, the SN state, each optimiser's ``count``, ``mu``, ``nu``,
    and ``step``.  The groups must be the ones ``acfg`` partitions into."""
    ts = new_train_state(cfg, acfg, tcfg, device=device, compute_dtype=compute_dtype)
    return load_train_state(ts, ts_numpy)


def mnist_train_state_from_jax(ts_numpy, cfg: DCGANConfig, acfg: MnistAlgoConfig,
                               tcfg: mnist_loop.MnistTrainConfig, device="cuda",
                               compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """The port's MNIST :class:`TrainState` from a JAX ``MnistTrainer``'s
    ``TrainState`` as numpy (or a :class:`NumpyTrainState`): parameters,
    state (SN ``u``, BN moving statistics), Adam moments and ``step``."""
    ts = mnist_loop.new_train_state(cfg, acfg, tcfg, device=device,
                                    compute_dtype=compute_dtype)
    return load_train_state(ts, ts_numpy)


def pggan_train_state_from_jax(ts_numpy, cfg: PGGANConfig, base: ResnetGANConfig,
                               tcfg: pggan_loop.PGGANTrainConfig, device="cuda",
                               compute_dtype: torch.dtype = torch.float32) -> TrainState:
    """The port's PGGAN :class:`TrainState` from a JAX ``PGGANTrainer``'s
    ``TrainState`` as numpy (or a :class:`NumpyTrainState`): every stage's
    parameters, the state (SN ``u``, the critic's BN statistics), Adam
    moments and ``step``."""
    ts = pggan_loop.PGGANTrainer(cfg, base, tcfg, device, compute_dtype).init()
    return load_train_state(ts, ts_numpy)


def load_train_state(ts: TrainState, ts_numpy) -> TrainState:
    """Copy a numpy train state into ``ts`` in place (its model, moments,
    counts and step) and return it."""
    if set(ts_numpy.groups) != set(ts.groups) or set(ts_numpy.opt_states) != set(ts.opt_states):
        raise KeyError(f"groups differ: {sorted(ts_numpy.groups)} vs {sorted(ts.groups)}")
    params = {layer: vs for g in ts_numpy.groups.values() for layer, vs in g.items()}
    load_tree(ts.gan, params, ts_numpy.state, prefix="")
    for g, st in ts.opt_states.items():
        adam = ts_numpy.opt_states[g][0]
        keys = list(ts.groups[g])
        for dst, src in ((st.mu, _by_key(adam.mu, keys)), (st.nu, _by_key(adam.nu, keys))):
            for d, a in zip(dst, src):
                if tuple(a.shape) != tuple(d.shape):
                    raise ValueError(f"{g} Adam moment of shape {a.shape}, want {tuple(d.shape)}")
                d.copy_(torch.from_numpy(np.array(a)))
        st.count = int(np.asarray(adam.count))
    ts.step = int(np.asarray(ts_numpy.step))
    return ts


def to_jax_train_state(ts: TrainState) -> NumpyTrainState:
    """``ts`` as a :class:`NumpyTrainState` (the JAX layout, numpy leaves)."""
    def tree(keys, tensors):
        out: NpTree = {}
        for (layer, var), t in zip(keys, tensors):
            out.setdefault(layer, {})[var] = t.detach().cpu().numpy().copy()
        return out

    groups = {g: tree(ps, ps.values()) for g, ps in ts.groups.items()}
    opt_states = {g: (AdamMoments(np.asarray(st.count, np.int32), tree(ts.groups[g], st.mu),
                                  tree(ts.groups[g], st.nu)), ())
                  for g, st in ts.opt_states.items()}
    return NumpyTrainState(groups, _np_tree(state_tree(ts.gan)), opt_states,
                           np.asarray(ts.step, np.int32))
