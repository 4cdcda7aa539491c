"""BigGAN (Brock, Donahue and Simonyan, ICLR 2019), its layers as the
authors' PyTorch reproduction defines them (ajbrock/BigGAN-PyTorch:
``BigGAN.py``'s ``G_arch``/``D_arch`` and ``layers.py``'s ``GBlock``,
``DBlock``, ``ccbn``, ``Attention``, ``SNConv2d``, ``SNLinear``,
``SNEmbedding``), in the port's layers: NHWC activations, HWIO filters,
``[in, out]`` linears, every product in the layer's ``compute_dtype``.

- The generator: a hierarchical latent (``z`` split into one chunk per
  block and one for the input), a shared class embedding joined to each
  block's chunk, GBlocks of cond-BN whose gain and offset are per sample,
  from spectral-normed linears of that join (``BN(x)·(1 + gain(c)) +
  bias(c)``, :class:`CondBN`), a non-local attention block after the block
  at ``attention_g``, then batch norm, ReLU, a 3x3 conv and tanh.  Every
  weight but the shared embedding is spectral-normed.
- The discriminator (``D_wide``): DBlocks whose first conv already goes to
  the block's width, attention after the block at ``attention_d``, a sum
  over the positions of ``relu(h)``, and a spectral-normed linear; its
  projection head is a spectral-normed embedding ``[V, C]``
  (:class:`DiscriminatorProjection`, with ``resnet_gan``'s interface), so
  ``algorithms/cifar.py``'s losses run on it unchanged.

Every norm takes the batch's statistics (BigGAN's running statistics serve
only its eval mode); the per-sample tables go through the cond-BN kernel as
tables of ``B`` rows indexed by ``arange(B)``, and the output norm as a
table of one row.  Spectral norm takes one power step from the stored
``u`` per call, the whole generator's or critic's weights in one group
(``ops/sn.py``); ``G.Input``'s ``[20, 24576]`` weight is normalized as its
transpose, whose ``u`` of 20 fits the kernel (BigGAN-PyTorch keeps 24,576).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rcgan_tpu_torch.core import initializers as inits
from rcgan_tpu_torch.core.module import Scoped
from rcgan_tpu_torch.ops.attention import attention
from rcgan_tpu_torch.ops.conv import Conv2dLib, mean_pool, upsample_depth_to_space
from rcgan_tpu_torch.ops.kernels.projection_kernel import all_label_projection_logits
from rcgan_tpu_torch.ops.kernels.runtime import resolve_device
from rcgan_tpu_torch.ops.linear import Embedding, LinearLib, take_rows
from rcgan_tpu_torch.ops.norm import cond_batchnorm
from rcgan_tpu_torch.ops.sn import (add_sn_state, clear_prepared, prepare_spectral_norms,
                                    sn_layers, spectral_normed_weight)


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    img_size: int = 128
    img_dim: int = 3
    dim_g: int = 96          # BigGAN's G_ch
    dim_d: int = 96          # D_ch
    z_dim: int = 120         # split into one chunk per G block and one for the input
    shared_dim: int = 128
    vocab_size: int = 1000
    attention_g: int = 64    # the resolution whose block attention follows
    attention_d: int = 64
    algorithm: str = "rcgan"  # biased | unbiased | rcgan | rcgan-u
    perm_type: str = "linear"

    @property
    def output_dim(self) -> int:
        return self.img_size * self.img_size * self.img_dim


def g_arch(ch: int, resolution: int) -> Dict[str, List[int]]:
    """``G_arch[resolution]``: each block's in and out channels and the
    resolution it outputs (every block upsamples)."""
    mults = {256: ([16, 16, 8, 8, 4, 2], [16, 8, 8, 4, 2, 1]),
             128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]),
             64: ([16, 16, 8, 4], [16, 8, 4, 2]),
             32: ([4, 4, 4], [4, 4, 4])}[resolution]
    return {"in": [ch * m for m in mults[0]], "out": [ch * m for m in mults[1]],
            "resolution": [8 * 2 ** i for i in range(len(mults[0]))]}


def d_arch(ch: int, resolution: int) -> Dict[str, list]:
    """``D_arch[resolution]`` of the wide critic: each block's in and out
    channels, whether it downsamples, and the resolution that places
    attention (BigGAN's table, whose 32x32 rows all read 16)."""
    ins, outs, down, res = {
        256: ([1, 2, 4, 8, 8, 16], [1, 2, 4, 8, 8, 16, 16], 6, [128, 64, 32, 16, 8, 4, 4]),
        128: ([1, 2, 4, 8, 16], [1, 2, 4, 8, 16, 16], 5, [64, 32, 16, 8, 4, 4]),
        64: ([1, 2, 4, 8], [1, 2, 4, 8, 16], 4, [32, 16, 8, 4, 4]),
        32: ([4, 4, 4], [4, 4, 4, 4], 2, [16, 16, 16, 16])}[resolution]
    return {"in": [3] + [ch * m for m in ins], "out": [ch * m for m in outs],
            "down": [i < down for i in range(len(outs))], "resolution": res}


def _conv(cin: int, cout: int, k: int, scope: str, seed: int, biases: bool = True) -> Conv2dLib:
    return Conv2dLib(cin, cout, k, scope, he_init=k == 3, biases=biases, seed=seed,
                     spectral_normed=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of NHWC ``x`` (``F.max_pool2d`` on its channels-last
    view, whose result is NHWC-contiguous again)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class CondBN(nn.Module):
    """``ccbn``: batch norm of ``x`` (eps 1e-5) with a per-sample gain ``1 +
    Gain(c)`` and offset ``Bias(c)`` from spectral-normed linears with no
    bias term (scopes ``<scope>.Gain``, ``<scope>.Bias``), through the
    cond-BN kernel with float32 tables of ``B`` rows; ``relu`` fuses the
    ReLU after it."""

    def __init__(self, cond_dim: int, channels: int, scope: str, seed: int = 0):
        super().__init__()
        kw = dict(biases=False, seed=seed, spectral_normed=True)
        self.gain = LinearLib(cond_dim, channels, scope + ".Gain", **kw)
        self.bias = LinearLib(cond_dim, channels, scope + ".Bias", **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor, relu: bool = True) -> torch.Tensor:
        rows = torch.arange(x.shape[0], device=x.device)
        scale = (1.0 + self.gain(c).float()).contiguous()
        offset = self.bias(c).float().contiguous()
        return cond_batchnorm(x.contiguous(), rows, scale, offset, relu=relu)


class BatchNormReLU(Scoped):
    """``layers.bn`` then ReLU: batch norm (eps 1e-5) with a learned
    ``gamma`` (ones) and ``beta`` (zeros), through the cond-BN kernel as a
    table of one row."""

    def __init__(self, channels: int, scope: str, seed: int = 0):
        super().__init__(scope, seed)
        self.add_param("gamma", (channels,), inits.ones)
        self.add_param("beta", (channels,), inits.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        return cond_batchnorm(x.contiguous(), rows, self.gamma[None], self.beta[None], relu=True)


class Attention(Scoped):
    """BigGAN's non-local block at ``channels`` C: ``θ = conv(x)`` to C/8,
    ``φ`` and ``g`` 1x1 convs to C/8 and C/2 then a 2x2 max pool,
    ``x + γ · conv_o(softmax(θ φᵀ) g)``; every conv spectral-normed with no
    bias, ``γ`` a learned scalar (``gamma [1]``).  The softmax product is
    ``ops/attention.py``'s op."""

    def __init__(self, channels: int, scope: str, seed: int = 0):
        super().__init__(scope, seed)
        self.theta = _conv(channels, channels // 8, 1, scope + ".Theta", seed, biases=False)
        self.phi = _conv(channels, channels // 8, 1, scope + ".Phi", seed, biases=False)
        self.g = _conv(channels, channels // 2, 1, scope + ".G", seed, biases=False)
        self.o = _conv(channels // 2, channels, 1, scope + ".O", seed, biases=False)
        self.add_param("gamma", (1,), inits.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        theta = self.theta(x).reshape(b, h * w, c // 8)
        phi = _max_pool(self.phi(x)).reshape(b, h * w // 4, c // 8)
        g = _max_pool(self.g(x)).reshape(b, h * w // 4, c // 2)
        o = self.o(attention(theta, phi, g).reshape(b, h, w, c // 2))
        return x + self.gamma.to(o.dtype) * o


class GBlock(nn.Module):
    """``relu(ccbn₁(x, c))``, upsample, conv1, ``relu(ccbn₂(·, c))``, conv2,
    plus the 1x1 conv of the upsampled ``x``."""

    def __init__(self, cin: int, cout: int, scope: str, cond_dim: int, seed: int = 0):
        super().__init__()
        self.bn1 = CondBN(cond_dim, cin, scope + ".BN1", seed)
        self.conv1 = _conv(cin, cout, 3, scope + ".Conv1", seed)
        self.bn2 = CondBN(cond_dim, cout, scope + ".BN2", seed)
        self.conv2 = _conv(cout, cout, 3, scope + ".Conv2", seed)
        self.shortcut = _conv(cin, cout, 1, scope + ".Shortcut", seed)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.conv1(upsample_depth_to_space(self.bn1(x, c)))
        h = self.conv2(self.bn2(h, c))
        return h + self.shortcut(upsample_depth_to_space(x))


class DBlock(nn.Module):
    """``conv2(relu(conv1(a(x))))`` then a 2x2 mean pool where the block
    downsamples, plus the shortcut; ``a`` is the identity in the first
    block (whose shortcut pools before its 1x1 conv) and a ReLU in the
    others (which pool after it).  The shortcut is the identity where the
    width holds and nothing is pooled."""

    def __init__(self, cin: int, cout: int, scope: str, down: bool, preact: bool,
                 seed: int = 0):
        super().__init__()
        self.down, self.preact = down, preact
        self.conv1 = _conv(cin, cout, 3, scope + ".Conv1", seed)
        self.conv2 = _conv(cout, cout, 3, scope + ".Conv2", seed)
        self.shortcut = _conv(cin, cout, 1, scope + ".Shortcut", seed) \
            if (cin != cout or down) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(F.relu(x) if self.preact else x)))
        if self.down:
            h = mean_pool(h)
        sc = x
        if self.preact:
            sc = self.shortcut(sc) if self.shortcut is not None else sc
            sc = mean_pool(sc) if self.down else sc
        else:
            sc = mean_pool(sc) if self.down else sc
            sc = self.shortcut(sc) if self.shortcut is not None else sc
        return h + sc


class Generator(nn.Module):
    """``z [B, z_dim]``, labels int ``[B]`` → flat image ``[B, output_dim]``
    in [-1, 1]; built on ``device`` (a CUDA device that is absent raises)."""

    def __init__(self, cfg: BigGANConfig = BigGANConfig(), seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        arch = g_arch(cfg.dim_g, cfg.img_size)
        self.chunk = cfg.z_dim // (len(arch["in"]) + 1)
        self.width0 = arch["in"][0]
        self.shared = Embedding(cfg.vocab_size, cfg.shared_dim, "G.Shared", seed)
        self.input = LinearLib(self.chunk, 16 * self.width0, "G.Input", seed=seed)
        add_sn_state(self.input, self.chunk, "W", transposed=True)
        self.input.spectral_normed = True
        cond = cfg.shared_dim + self.chunk
        self.blocks = nn.ModuleList()
        self.attention = nn.ModuleDict()
        for i, (cin, cout, res) in enumerate(zip(arch["in"], arch["out"], arch["resolution"])):
            scope = f"G.Block.{i + 1}"
            self.blocks.append(GBlock(cin, cout, scope, cond, seed))
            if res == cfg.attention_g:
                self.attention[str(i)] = Attention(cout, scope + ".Attention", seed)
        self.output_norm = BatchNormReLU(arch["out"][-1], "G.OutputNorm", seed)
        self.output = _conv(arch["out"][-1], cfg.img_dim, 3, "G.Output", seed)
        self._sn_layers = sn_layers(self)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.input.W.device

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # the power step of every spectral-normed weight in one group
        prepare_spectral_norms(self._sn_layers)
        try:
            y = self.shared(labels)
            zs = torch.split(z, self.chunk, dim=1)
            h = self.input(zs[0]).reshape(-1, 4, 4, self.width0)
            for i, block in enumerate(self.blocks):
                h = block(h, torch.cat([y, zs[i + 1]], dim=1))
                if str(i) in self.attention:
                    h = self.attention[str(i)](h)
            out = torch.tanh(self.output(self.output_norm(h)))
            return out.reshape(-1, cfg.output_dim)
        finally:
            clear_prepared(self._sn_layers)


class Discriminator(nn.Module):
    """Flat image ``[B, output_dim]`` → (features ``[B, C]``, the sum over
    the positions of the last block's ReLU, and the linear logit ``[B]``),
    the interface of ``resnet_gan.Discriminator``; the labels are not read
    (the projection head reads them)."""

    def __init__(self, cfg: BigGANConfig = BigGANConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        arch = d_arch(cfg.dim_d, cfg.img_size)
        self.blocks = nn.ModuleList()
        self.attention = nn.ModuleDict()
        for i, (cin, cout, down, res) in enumerate(zip(arch["in"], arch["out"], arch["down"],
                                                       arch["resolution"])):
            scope = f"D.Block.{i + 1}"
            self.blocks.append(DBlock(cin, cout, scope, down, i > 0, seed))
            if res == cfg.attention_d:
                self.attention[str(i)] = Attention(cout, scope + ".Attention", seed)
        self.output = LinearLib(arch["out"][-1], 1, "D.Output", seed=seed, spectral_normed=True)
        self._sn_layers = sn_layers(self)

    def forward(self, inputs: torch.Tensor, labels: Optional[torch.Tensor]):
        cfg = self.cfg
        h = inputs.reshape(-1, cfg.img_size, cfg.img_size, cfg.img_dim)
        prepare_spectral_norms(self._sn_layers)
        try:
            for i, block in enumerate(self.blocks):
                h = block(h)
                if str(i) in self.attention:
                    h = self.attention[str(i)](h)
            feat = F.relu(h).sum(dim=(1, 2))
            return feat, self.output(feat).reshape(-1)
        finally:
            clear_prepared(self._sn_layers)


class DiscriminatorProjection(Scoped):
    """``SNEmbedding``: the projection table ``D.Embedding/embedding_map [V,
    C]``, spectral-normed as BigGAN-PyTorch normalizes an embedding (``u``
    over the V labels: the table's transpose in the port's ``[m, cout]``
    form); ``forward`` gathers each label's row, :meth:`all_label_logits`
    takes every label's (``resnet_gan``'s interface)."""

    def __init__(self, cfg: BigGANConfig = BigGANConfig(), seed: int = 0):
        super().__init__("D.Embedding", seed)
        c = d_arch(cfg.dim_d, cfg.img_size)["out"][-1]
        self.add_param("embedding_map", (cfg.vocab_size, c), inits.uniform_range(0.08))
        add_sn_state(self, cfg.vocab_size, "embedding_map", transposed=True)
        self.spectral_normed = True

    def table(self) -> torch.Tensor:
        return spectral_normed_weight(self, self.embedding_map)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return take_rows(self.table(), labels)

    def all_label_logits(self, features: torch.Tensor, wgan: torch.Tensor) -> torch.Tensor:
        """float32 logits against every label's row, ``[B, V]``, through the
        projection op (its ``addmm`` route past the kernel's table size)."""
        return all_label_projection_logits(features.contiguous(), self.table().contiguous(),
                                           wgan.reshape(-1, 1).contiguous())
