"""The eval classifiers, the counterpart of ``rcgan_tpu/evals/classifier.py``
(``mnist_cnn``, ``cifar_resnet``, ``EvalClassifier``, ``train_pinned``,
``generated_label_accuracy``).

The reference scores generated images with frozen GraphDefs, a ResNet-110
for CIFAR (``cifar10/gan_resnet.py:424-455``) and ``mnist_dcnn`` for MNIST
(``mnist/utils.py:273-306``, missing from the reference repo).  The JAX
package stands in compact nets trained once on clean labels, their held-out
clean accuracy pinned with the weights: a pre-activation ResNet for CIFAR
and a conv-pool x2 + 2 dense CNN for MNIST.  The port builds the same nets
from its own layers (``Conv2dLib``, ``LinearLib``, ``mean_pool``), under
the same scope names, so a weight tree moves between the two by name: a
classifier saved by the JAX package loads here, and the other way round.

The classifiers run float32 with TF32 off (``float32_policy``), while
training may run bf16.  The CIFAR ResNet's 3x3 convs at 64-256 channels
reach the FFMA conv3x3 kernel on the card (the 3-channel stem goes to
cuDNN); the MNIST CNN's 5x5 convs go to cuDNN (``F.conv2d``), as JAX
leaves them to XLA.

JAX jits the classifier's ``logits`` and its train step; the port runs
each as one body (``train/graphs.py``), its batch and Adam's scalars read
from a block that one copy fills each step.  On a card ``logits`` is
captured in a CUDA graph once per batch shape; the train step is captured
once per :meth:`EvalClassifier.train` call only when asked: it is
device-bound, and its capture costs more than its replays save
(``PERF.md`` §5).
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.core.module import float32_policy, param_tree, scoped_modules
from rcgan_tpu_torch.ops.conv import Conv2dLib, mean_pool
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import LinearLib
from rcgan_tpu_torch.train.graphs import Passes, Program, StepBlock, capture_on
from rcgan_tpu_torch.train.state import AdamState, ScalelessAdam, train_state_key


class _Block(nn.Module):
    """Pre-activation block: ``sc + conv(relu(conv(relu(h))))``, the
    shortcut a 1x1 conv (after a mean pool when it downsamples) where the
    shape changes."""

    def __init__(self, cin: int, cout: int, name: str, down: bool, seed: int):
        super().__init__()
        self.down = down
        self.sc = Conv2dLib(cin, cout, 1, name + ".sc", he_init=False, seed=seed) \
            if down or cin != cout else None
        self.c1 = Conv2dLib(cin, cout, 3, name + ".c1", seed=seed)
        self.c2 = Conv2dLib(cout, cout, 3, name + ".c2", seed=seed)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        sc = h
        if self.sc is not None:
            sc = self.sc(mean_pool(h) if self.down else h)
        o = self.c2(torch.relu(self.c1(torch.relu(h))))
        if self.down:
            o = mean_pool(o)
        return sc + o


class CifarResnet(nn.Module):
    """JAX ``cifar_resnet``: ``x [B, 32, 32, 3]`` in [-1, 1] → logits
    ``[B, 10]``.  Fully convolutional up to a global mean pool."""

    def __init__(self, dim: int = 64, seed: int = 0):
        super().__init__()
        self.stem = Conv2dLib(3, dim, 3, "cls.stem", seed=seed)
        self.blocks = nn.ModuleList([
            _Block(dim, dim, "cls.b1", False, seed),
            _Block(dim, dim * 2, "cls.b2", True, seed),
            _Block(dim * 2, dim * 2, "cls.b3", False, seed),
            _Block(dim * 2, dim * 4, "cls.b4", True, seed),
            _Block(dim * 4, dim * 4, "cls.b5", False, seed),
        ])
        self.head = LinearLib(dim * 4, 10, "cls.head", seed=seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for b in self.blocks:
            h = b(h)
        h = torch.relu(h).mean(dim=(1, 2))
        return self.head(h)


class MnistCnn(nn.Module):
    """JAX ``mnist_cnn``: ``x [B, 28, 28, 1]`` in [0, 1] → logits ``[B, 10]``;
    two 5x5 stride-1 convs, each followed by a ReLU and a 2x2 mean pool, then
    two dense layers."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.conv1 = Conv2dLib(1, 32, 5, "cls.conv1", seed=seed)
        self.conv2 = Conv2dLib(32, 64, 5, "cls.conv2", seed=seed)
        self.fc1 = LinearLib(7 * 7 * 64, 256, "cls.fc1", seed=seed)
        self.fc2 = LinearLib(256, 10, "cls.fc2", seed=seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = mean_pool(torch.relu(self.conv1(x)))
        h = mean_pool(torch.relu(self.conv2(h)))
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        return self.fc2(h)


def cifar_resnet(dim: int = 64, seed: int = 0, device="cuda") -> CifarResnet:
    """The eval ResNet of width ``dim`` with parameters drawn from ``seed``,
    on ``device``."""
    return CifarResnet(dim, seed).to(resolve_device(device))


class EvalClassifier:
    """init/train/predict around a net built by ``build(seed)`` on
    ``device``, float32.  ``params`` is its weight tree in the JAX layout
    (numpy), what :meth:`save` writes and :meth:`load` reads.  ``graphs``
    (module doc): by default a CUDA device captures ``logits`` and runs
    the train step eagerly; ``True`` captures both, ``False`` neither, and
    asking the CPU for graphs raises."""

    def __init__(self, build: Callable[[int], nn.Module], input_shape: Tuple[int, ...],
                 device="cuda", graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        float32_policy(torch.float32)
        self.build = build
        self.input_shape = input_shape
        self.net = None
        self.meta: dict = {}
        self.graphs = capture_on(self.device, graphs)
        self.train_graphs = graphs is True
        self._logits = Passes(self._logits_pass, {"x": torch.float32}, self.device, self.graphs)
        self.train_program: Optional[Program] = None  # the last train call's step

    def init(self, seed: int = 0) -> nn.Module:
        self.net = self.build(seed).to(self.device)
        return self.net

    @property
    def params(self):
        return {layer: {var: t.cpu().numpy().copy() for var, t in d.items()}
                for layer, d in param_tree(self.net).items()}

    def load_params(self, tree) -> None:
        """Copy a ``{layer: {var: array}}`` tree into the net by name; every
        layer and var must match in name and shape."""
        if self.net is None:
            self.init(0)
        mods = scoped_modules(self.net)
        if set(tree) != set(mods):
            raise KeyError(f"classifier layers differ: {sorted(set(mods) ^ set(tree))}")
        with torch.no_grad():
            for layer, m in mods.items():
                for var, p in m.named_parameters(recurse=False):
                    src = torch.from_numpy(np.asarray(tree[layer][var], np.float32))
                    if tuple(src.shape) != tuple(p.shape):
                        raise ValueError(f"{layer}/{var}: shape {tuple(src.shape)}, net wants "
                                         f"{tuple(p.shape)}")
                    p.copy_(src)

    def logits(self, x) -> torch.Tensor:
        """float32 logits of ``x [B, *input_shape]`` (numpy or tensor) on the
        classifier's device, a tensor of their own; on a card the pass is
        captured once per batch shape."""
        return self._logits({"x": x}, self.net)

    @staticmethod
    def _logits_pass(inputs: Dict[str, torch.Tensor], net: nn.Module) -> torch.Tensor:
        with torch.no_grad():
            return net(inputs["x"]).float()

    def predict(self, x: np.ndarray, batch_size: int = 500) -> np.ndarray:
        """Argmax labels, every batch issued before one fetch at the end."""
        outs = [self.logits(x[i: i + batch_size]).argmax(-1) for i in range(0, len(x), batch_size)]
        return torch.cat(outs).cpu().numpy()

    def train(self, seed: int, x: np.ndarray, y: np.ndarray, epochs: int = 3,
              batch_size: int = 256, lr: float = 1e-3) -> float:
        """Adam (β 0.9, 0.999) and softmax cross-entropy on clean labels,
        epochs shuffled by ``RandomState(0)`` as JAX's; returns the last
        batch's train accuracy (0.0 when no full batch fits)."""
        if self.net is None:
            self.init(seed)
        params = list(self.net.parameters())
        opt = ScalelessAdam(0.9, 0.999)
        state = opt.init(params)
        prog = self.train_program = Program(
            functools.partial(self._train_step, params, opt),
            {"x": torch.float32, "y": torch.int64, "adam": torch.float32}, self.device,
            self.train_graphs, {"acc": (torch.float32, ())})
        n = len(x)
        stepped = False
        rs = np.random.RandomState(0)
        for _ in range(epochs):
            perm = rs.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = perm[i: i + batch_size]
                state.count += 1
                prog.run([{"x": np.asarray(x[idx], np.float32), "y": np.asarray(y[idx], np.int64),
                           "adam": opt.scalars(state.count, lr)}], state,
                         lambda: train_state_key(None, params, state.mu, state.nu))
                stepped = True
        acc = float(prog.read(1)["acc"][0]) if stepped else 0.0
        prog.captured.reset()  # the graph and its pool go; its counts and times stay
        return acc

    def _train_step(self, params: List[torch.Tensor], opt: ScalelessAdam, blk: StepBlock,
                    state: AdamState) -> None:
        """One Adam step on the block's row ``counter`` (the batch and
        :meth:`ScalelessAdam.scalars` of the step's count), in place on the
        net's parameters and ``state``; the batch's accuracy to the row."""
        xb, yb = blk.row("x"), blk.row("y")
        logits = self.net(xb)
        loss = F.cross_entropy(logits, yb)
        grads = torch.autograd.grad(loss, params)
        opt.apply_(params, grads, state, blk.row("adam"))
        blk.write("acc", (logits.argmax(-1) == yb).float().mean())
        blk.advance()

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        """Top-1 accuracy on (clean) data, the classifier's yardstick."""
        return float((self.predict(x) == np.asarray(y)).mean())

    def save(self, path: str, meta: dict | None = None):
        if meta is not None:
            self.meta = dict(meta)
        with open(path, "wb") as f:
            pickle.dump({"params": self.params, "meta": self.meta}, f)

    def load(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict) and "params" in blob and "meta" in blob:
            tree, self.meta = blob["params"], blob["meta"]
        else:  # a legacy cache: the raw tree, no pin
            tree, self.meta = blob, {}
        self.load_params(tree)
        return True


# A cached classifier may regress (stale cache, changed data); gen-label-acc
# only means something when the scorer is good, so loading fails when the
# re-measured clean accuracy drops below the pin by more than this.
PIN_TOLERANCE = 0.02


def train_pinned(cls: EvalClassifier, path: str, x_train: np.ndarray, y_train: np.ndarray,
                 x_val: np.ndarray, y_val: np.ndarray, epochs: int = 5, seed: int = 123,
                 max_val: int = 5000) -> float:
    """Load or train an eval classifier with a pinned clean accuracy: the
    accuracy on held-out clean data is stored with the weights, and a cached
    classifier that scores below its pin raises.  Returns the clean
    accuracy."""
    xv, yv = x_val[:max_val], y_val[:max_val]
    if cls.load(path):
        pinned = cls.meta.get("clean_accuracy")
        if pinned is not None:
            acc = cls.accuracy(xv, yv)
            if acc < pinned - PIN_TOLERANCE:
                raise RuntimeError(
                    f"cached eval classifier {path} scores {acc:.4f} on clean data, below its "
                    f"pin {pinned:.4f} (tol {PIN_TOLERANCE}); delete the cache to retrain")
            return acc
        cls.net = None  # a legacy cache without a pin: retrain to create one
    cls.train(seed, x_train, y_train, epochs=epochs)
    acc = cls.accuracy(xv, yv)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cls.save(path, meta={"clean_accuracy": acc, "version": 2, "epochs": epochs,
                         "n_train": int(len(x_train))})
    return acc


def mnist_classifier(device="cuda", graphs: Optional[bool] = None) -> EvalClassifier:
    """The MNIST eval classifier (JAX ``mnist_classifier``)."""
    return EvalClassifier(lambda seed: MnistCnn(seed), (28, 28, 1), device, graphs)


def cifar_classifier(dim: int = 64, img_size: int = 32, device="cuda",
                     graphs: Optional[bool] = None) -> EvalClassifier:
    """The CIFAR eval classifier (fully convolutional: any ``img_size``)."""
    return EvalClassifier(lambda seed: CifarResnet(dim, seed), (img_size, img_size, 3), device,
                          graphs)


def generated_label_accuracy(classifier: EvalClassifier, samples: np.ndarray, labels: np.ndarray,
                             confusion_matrix: np.ndarray | None = None) -> float:
    """The fraction of generated images the eval classifier assigns to their
    conditioning label (``cifar10/gan_resnet.py:424-455``).
    ``confusion_matrix``: the learned C of the permutation-corrected variant
    (``--perm_gen_label_acc``): labels are first mapped through the
    argmax-binarized C."""
    if confusion_matrix is not None:
        perm = np.argmax(confusion_matrix, axis=-1)
        labels = perm[labels]
    preds = classifier.predict(samples)
    return float((preds == labels).mean())
