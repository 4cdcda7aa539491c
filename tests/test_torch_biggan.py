"""BigGAN (``rcgan_tpu_torch/models/biggan.py``) against the benchmark's
plain reference (``benchmark/reference/biggan128.py``) on the CPU, at a tiny
size that keeps every kind of layer: ``ch`` 8, 32x32 images with attention
at 16 in G and D (BigGAN's 32x32 table: four attention blocks in D), 10
classes, batch 4, float32, the same weights drawn by ``benchmark/weights.py``.

- the generator's image and the critic's features, logit and projection;
- the attention op (``ops/attention.py``): its forward and backward against
  autograd of a plain softmax, on the CPU route and on the CUDA route's
  code (PyTorch's fused attention, which the CPU runs too) with the
  launches faked onto CPU tensors;
- the reference's comparison group ``gen_cond`` (G's conditioning
  leaves), and what a half batch reads in it;
- cond-BN with per-sample tables of B rows (``CondBN``) against the
  reference's formula, forward and gradients;
- one rcgan and one rcgan-u cycle through ``CifarTrainer.step_scan`` and
  the benchmark's driver against the reference's cycles: first gradients
  and the state after three cycles;
- the pieces it brought to shared code: spectral norm of a transposed
  weight, the critic's own learning rate, the sampler keeping G's ``u``,
  and the projection's route past its kernel's table.

The tolerances are float32's: both sides sum in other orders, and a
spectral norm's gradient through its power step carries that rounding
further (a few 1e-4 of a gradient's norm here, ``grad_diff.gen``); each
bound sits an order of magnitude above what these seeds read.
"""

import math

import numpy as np
import pytest
import torch

from benchmark import calibrate, manifest
from benchmark.reference import biggan128 as ref
from benchmark.reference.layers import Precision, cond_batch_norm, spectral_normed
from benchmark.weights import draw
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig, CifarGAN
from rcgan_tpu_torch.core.module import scoped_modules
from rcgan_tpu_torch.models import biggan
from rcgan_tpu_torch.models.resnet_gan import sample
from rcgan_tpu_torch.ops import attention as attn
from rcgan_tpu_torch.ops.kernels import projection_kernel, runtime
from rcgan_tpu_torch.ops.kernels.sn_kernel import sn_plain
from rcgan_tpu_torch.ops.sn import prepare_spectral_norms, spectral_normed_weight
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from torch_parity import cuda_impls_on_cpu

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = dict(img_size=32, img_dim=3, dim_g=8, dim_d=8, z_dim=120, shared_dim=16,
             vocab_size=10, attention_g=16, attention_d=16)
B = 4


def _gan(algorithm="rcgan", seed=3):
    """A tiny ``CifarGAN`` and the reference's model on the same drawn
    weights and ``u``."""
    traffic = {"algorithm": algorithm}
    params, u = draw(ref.param_specs(MODEL, traffic), ref.sn_scopes(MODEL, traffic), seed, "cpu")
    gan = CifarGAN(biggan.BigGANConfig(**MODEL, algorithm=algorithm),
                   CifarAlgoConfig(algorithm=algorithm, vocab_size=MODEL["vocab_size"]),
                   device="cpu")
    mods = scoped_modules(gan)
    have = {(m.scope, n): p for m in mods.values() for n, p in m.named_parameters(recurse=False)}
    assert set(have) == set(params)
    with torch.no_grad():
        for k, p in have.items():
            p.copy_(params[k])
        for s, v in u.items():
            mods[s].u.copy_(v)
    return gan, ref.Model(MODEL, traffic, dict(params), dict(u), Precision())


def _rel(a, b):
    return float((a.detach() - b.detach()).abs().max() / b.detach().abs().max())


def test_forwards_match_the_reference():
    """G's image, D's features and logit and the projection rows, from the
    same weights, and every ``u`` after them."""
    gan, model = _gan()
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((B, MODEL["z_dim"]), generator=gen)
    labels = torch.randint(0, MODEL["vocab_size"], (B,), generator=gen)
    img = gan.G(z, labels)
    want = model.generator(z, labels)
    assert img.shape == (B, 32 * 32 * 3) and _rel(img, want) < 1e-5
    feat, wgan = gan.D(img.detach(), labels)
    feat_r, wgan_r = model.discriminator(want.detach(), store=True)
    assert feat.shape == (B, 4 * MODEL["dim_d"]) and _rel(feat, feat_r) < 1e-5
    assert _rel(wgan, wgan_r) < 1e-4
    assert _rel(gan.projection(labels), model.projection(labels)) < 1e-5
    mods = scoped_modules(gan)
    for scope, u in model.u.items():
        assert torch.allclose(mods[scope].u, u, rtol=1e-5, atol=1e-6), scope
    assert len(gan.D.attention) == 4 and len(gan.G.attention) == 1


def _softmax_attention(q, k, v):
    return torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v


@pytest.mark.parametrize("route", ["cpu", "cuda_code"])
@pytest.mark.parametrize("dq,dv", [(3, 12), (8, 8), (12, 4)])
def test_attention_op_matches_a_plain_softmax(monkeypatch, route, dq, dv):
    """Forward and the three gradients against autograd of ``softmax(q kᵀ)
    v`` (unscaled); on ``cuda_code`` the CUDA implementations run on CPU
    tensors (PyTorch's fused attention there too), each call counted once
    under ``attn`` and ``attn_bwd``."""
    if route == "cuda_code":
        monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
        cuda_impls_on_cpu(monkeypatch, "attention", "attention_backward")
    runtime.reset_launch_counts()
    gen = torch.Generator().manual_seed(dq)
    q, k, v = (torch.randn(s, generator=gen) for s in ((2, 64, dq), (2, 16, dq), (2, 16, dv)))
    g = torch.randn((2, 64, dv), generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn.attention(*ins)
    grads = torch.autograd.grad(out, ins, g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = _softmax_attention(*leaves)
    want_grads = torch.autograd.grad(want, leaves, g)
    for a, b in zip((out, *grads), (want, *want_grads)):
        assert _rel(a, b) < 1e-5
    counted = runtime.variant_counts("attn"), runtime.variant_counts("attn_bwd")
    assert counted == (({"sdpa": 1}, {"sdpa": 1}) if route == "cuda_code"
                       else ({"sdpa": 0}, {"sdpa": 0}))
    assert runtime.launch_counts() == dict.fromkeys(runtime.KERNELS, 0)
    assert attn.fused_backend(q, k, v) in attn.FUSED


def test_attention_op_fake_and_bf16():
    """The fake implementation's shapes, and bf16 in and out."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = torch.empty(3, 64, 4), torch.empty(3, 16, 4), torch.empty(3, 16, 10)
        assert attn.attention_op(q, k, v).shape == (3, 64, 10)
        assert [t.shape for t in attn.attention_backward_op(torch.empty(3, 64, 10), q, k, v)] \
            == [q.shape, k.shape, v.shape]
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen) for s in ((2, 64, 4), (2, 16, 4), (2, 16, 8)))
    out = attn.attention(*(t.bfloat16() for t in (q, k, v)))
    assert out.dtype == torch.bfloat16 and _rel(out.float(), _softmax_attention(q, k, v)) < 2e-2


def test_conditioning_group_reads_a_half_batch():
    """``reference.groups``' ``gen_cond``: G's conditioning leaves, ahead of
    the optimiser groups, which ``change_gap`` still reads them by; and its
    ``norm_gap`` reads about √2 − 1 for gradients that are sums of
    independent per-sample terms taken over half of the batch."""
    from benchmark import check
    from benchmark.reference import cifar_sngan

    specs = ref.param_specs(MODEL, {"algorithm": "rcgan"})
    groups = ref.groups(specs)
    assert list(groups)[0] == "gen_cond" and list(groups)[1:] == list(cifar_sngan.groups(specs))
    cond = groups["gen_cond"]
    n_blocks = len(ref.g_arch(MODEL["dim_g"], MODEL["img_size"])["in"])
    assert set(cond) == {("G.Shared", "embedding_map"), ("G.Input", "W")} | {
        (f"G.Block.{i}.{bn}.{t}", "W") for i in range(1, n_blocks + 1)
        for bn in ("BN1", "BN2") for t in ("Gain", "Bias")}
    assert set(cond) <= set(groups["gen"])

    gen = torch.Generator().manual_seed(5)
    before = {k: torch.randn(shape, generator=gen) for k, (shape, _) in specs.items()}
    n = 4096
    terms = {k: torch.randn((n, *before[k].shape), generator=gen) for k in cond}
    full = {k: t.mean(0) for k, t in terms.items()}
    half = {k: t[:n // 2].mean(0) for k, t in terms.items()}
    got = check.gradient_numbers(half, full, {"gen_cond": cond})["norm_gap.gen_cond"]
    assert abs(got - (math.sqrt(2) - 1)) < 0.02

    side = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in before.items()}
    want = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in before.items()}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in before.items()}
    a, b = ({"grads": grads, "params": p} for p in (side, want))
    gaps = [check.numbers(a, b, {"grads": {}}, before, gs, ["change_gap"])
            for gs in (groups, cifar_sngan.groups(specs))]
    assert gaps[0] == gaps[1]


def test_cond_bn_takes_per_sample_tables():
    """``BN(x)(1 + gain(c)) + bias(c)`` with tables of B rows through the
    cond-BN op, against the reference's formula: the output and the
    gradients of x and of both linears' weights."""
    gen = torch.Generator().manual_seed(5)
    cbn = biggan.CondBN(12, 6, "T.BN")
    x = torch.randn((B, 4, 4, 6), generator=gen) * 2 + 1
    c = torch.randn((B, 12), generator=gen)
    g = torch.randn((B, 4, 4, 6), generator=gen)
    u_g, u_b = cbn.gain.u.clone(), cbn.bias.u.clone()
    xs = x.clone().requires_grad_(True)
    out = cbn(xs, c)
    got = torch.autograd.grad(out, (xs, cbn.gain.W, cbn.bias.W), g)
    wg, wb = (w.detach().clone().requires_grad_(True) for w in (cbn.gain.W, cbn.bias.W))
    xr = x.clone().requires_grad_(True)
    scale = 1.0 + c @ spectral_normed(wg, u_g)[0]
    offset = c @ spectral_normed(wb, u_b)[0]
    want = torch.relu(cond_batch_norm(xr, torch.arange(B), scale, offset))
    want_g = torch.autograd.grad(want, (xr, wg, wb), g)
    assert _rel(out, want) < 1e-5
    for a, b in zip(got, want_g):
        assert _rel(a, b) < 1e-4


def _tiny(algorithm):
    def apply(cfg, traffic):
        cfg["model"].update(MODEL)
        cfg["batch_size"] = B
        cfg["dataset"]["train_size"] = 24
        cfg["compute_dtype"] = "float32"
        traffic.update(scan_block=2, trace_units=1, algorithm=algorithm)
        if algorithm == "rcgan-u":
            traffic.update(confuse_init=True, confuse_init_diag=0.6)
    return apply


@pytest.mark.parametrize("algorithm", ["rcgan", "rcgan-u"])
def test_cycles_match_the_reference(algorithm):
    """Three cycles through ``CifarTrainer.step_scan`` (the benchmark's
    driver, one call a cycle) against the reference's: the losses, every
    group's first gradient (the generator's followed from the program's
    critic) and every leaf's change."""
    wl = manifest.workload("biggan128.train_rcgan")
    r = calibrate.readings(wl, 2**31 + 21, device="cpu", overrides=_tiny(algorithm),
                           faults=False)
    got = r["program"]
    assert all(v < 1e-2 for k, v in got.items() if k.startswith(("grad_diff.", "norm_gap."))), got
    assert got["change_gap"] < 3e-2, got
    for row_p, row_q in zip(r["losses"]["program"], r["losses"]["reference"]):
        assert all(abs(p - q) < 1e-3 * max(abs(q), 1.0) for p, q in zip(row_p, row_q)), r["losses"]
    if algorithm == "rcgan-u":
        assert "grad_diff.confusion" in got


def test_transposed_spectral_norm():
    """A layer normalized as its transpose takes ``sn_plain`` of ``Wᵀ`` with
    ``u`` on the input side, alone and in a prepared group, and advances
    its ``u``."""
    gan, _ = _gan()
    layer = gan.G.input
    assert layer.u.shape == (1, layer.W.shape[0]) and layer.sn_transposed
    w_bar, u_new, _ = sn_plain(layer.W.detach().T.contiguous(), layer.u)
    u0 = layer.u.clone()
    got = spectral_normed_weight(layer, layer.W)
    assert torch.allclose(got, w_bar.T, rtol=1e-6, atol=1e-7)
    assert torch.allclose(layer.u, u_new) and not torch.equal(layer.u, u0)
    layer.u = u0
    prepare_spectral_norms([layer, gan.G.output])
    assert torch.allclose(spectral_normed_weight(layer, layer.W), w_bar.T, rtol=1e-6, atol=1e-7)
    spectral_normed_weight(gan.G.output, gan.G.output.Filters)


def test_critic_learning_rate():
    """``d_lr`` sets the critic steps' Adam rows and leaves the generator's
    at ``lr``; without it the rows are the single-rate ones."""
    cfg = biggan.BigGANConfig(**MODEL)
    acfg = CifarAlgoConfig(vocab_size=10)
    c = np.full((10, 10), 0.4 / 9) + (0.6 - 0.4 / 9) * np.eye(10)
    n = 8
    ds = {"images": torch.zeros((n, 32 * 32 * 3), dtype=torch.uint8),
          **{k: torch.zeros(n, dtype=torch.int32)
             for k in ("labels", "labels_random", "labels_biased")},
          "labels_inv_weights": torch.zeros((n, 10))}
    rows = {}
    for d_lr in (None, 4e-4):
        tr = CifarTrainer(cfg, acfg, CifarTrainConfig(lr=1e-4, d_lr=d_lr, n_critic=2,
                                                      gen_bs_multiple=1, decay=False),
                          c, device="cpu", device_dataset=ds)
        ts = tr.init(0)
        row = tr._cycle_row(ts, {"index": np.zeros((2, B), np.int64)},
                            {"random": np.zeros(B), "biased": np.zeros(B)}, 1, 0, None)
        rows[d_lr] = row["adam"][:, 0]
    # row 0 the generator's step, row 1 the confusion matrix's (none under rcgan)
    assert np.allclose(rows[None][[0, 2, 3]], 1e-4) and np.allclose(rows[4e-4][0], 1e-4)
    assert np.allclose(rows[4e-4][2:], 4e-4) and rows[None][1] == rows[4e-4][1] == 0


def test_sample_keeps_the_generator_state():
    """A sample runs under inference mode and leaves every ``u`` of the
    spectral-normed generator as it was."""
    gan, _ = _gan()
    before = {s: m.u.clone() for s, m in scoped_modules(gan.G).items() if hasattr(m, "u")}
    out = sample(gan.G, torch.randn(B, MODEL["z_dim"]), torch.arange(B))
    assert out.shape == (B, 32 * 32 * 3) and bool(torch.isfinite(out).all())
    assert all(torch.equal(m.u, before[s]) for s, m in scoped_modules(gan.G).items()
               if hasattr(m, "u"))


def test_projection_routes_wide_tables_to_addmm(monkeypatch):
    """On the CUDA route a table of V·D above the kernel's 12,288 floats
    (BigGAN's 1000 x 1536) is one float32 ``addmm``, counted under its
    variant and not as a launch; a table that fits launches the kernel."""
    launched = []
    monkeypatch.setattr(runtime, "on_cuda", lambda *ts: True)
    cuda_impls_on_cpu(monkeypatch, "projection_logits")
    monkeypatch.setattr(projection_kernel, "_launch",
                        lambda f, e, w: launched.append(e.shape) or
                        (runtime.count_launch("projection", variant="cuda"),
                         projection_kernel.projection_plain(f, e, w))[1])
    runtime.reset_launch_counts()
    gen = torch.Generator().manual_seed(2)
    feat, wgan = torch.randn((8, 24), generator=gen), torch.randn((8, 1), generator=gen)
    wide, narrow = torch.randn((1000, 24), generator=gen), torch.randn((10, 24), generator=gen)
    assert projection_kernel.projection_route(1000, 1536) == "addmm"
    assert projection_kernel.projection_route(10, 128) == "cuda"
    for emb in (wide, narrow):
        got = projection_kernel.all_label_projection_logits(feat, emb.bfloat16(), wgan)
        want = feat @ emb.bfloat16().float().T + wgan
        assert got.dtype == torch.float32 and _rel(got, want) < 1e-6
    assert launched == [(10, 24)]
    assert runtime.variant_counts("projection") == {"cuda": 1, "addmm": 1}
    assert runtime.launch_counts()["projection"] == 1


def test_work_counts_the_reference_products():
    """``benchmark/work/biggan128.py`` against the FLOP counter over the
    reference's first two cycles at the tiny size (its attention core run
    without checkpointing, which would count the recomputed forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = manifest.config("biggan128")
    traffic = dict(manifest.workload("biggan128.train_rcgan")["traffic"])
    _tiny("rcgan")(cfg, traffic)
    params, u = draw(ref.param_specs(MODEL, traffic), ref.sn_scopes(MODEL, traffic), 3, "cpu")
    work = manifest.work("biggan128")
    gen = torch.Generator().manual_seed(0)
    dim = 32 * 32 * 3

    def labels(n):
        return torch.randint(0, 10, (n,), generator=gen)

    feeds = [{"iteration": it, "seed": 7 + it,
              "batches": [{"images": torch.randint(0, 256, (B, dim), generator=gen,
                                                   dtype=torch.uint8),
                           "labels": labels(B), "labels_random": labels(B),
                           "labels_biased": labels(B)} for _ in range(2)],
              "random": labels(B), "biased": labels(B)} for it in (0, 1)]
    c = torch.full((10, 10), 0.4 / 9) + (0.6 - 0.4 / 9) * torch.eye(10)
    old = ref.checkpoint
    ref.checkpoint = lambda fn, *a, **k: fn(*a)
    try:
        with FlopCounterMode(display=False) as counter:
            ref.run(cfg, traffic, params, u, feeds, c, Precision())
    finally:
        ref.checkpoint = old
    want = sum(w.flops for it in (0, 1) for w in work.step_work(cfg, traffic, it))
    assert counter.get_total_flops() == want


def test_full_size_work():
    """At the configuration's own sizes a generator image is 42.2 GFLOP
    forward and a critic image 21.7, and an rcgan cycle of batch 256 with
    two critic steps 131.8 TFLOP (its attention 2.4% of it)."""
    cfg = manifest.config("biggan128")
    traffic = manifest.workload("biggan128.train_rcgan")["traffic"]
    work = manifest.work("biggan128")
    g = sum(w.flops for w in work._generator(cfg["model"], 1, False, 2))
    d = sum(w.flops for w in work._critic(cfg["model"], 1, False, False, 2) if w.phase == "fwd")
    total = [w for w in work.step_work(cfg, traffic)]
    flops = sum(w.flops for w in total)
    assert math.isclose(g, 42.24e9, rel_tol=1e-3) and math.isclose(d, 21.67e9, rel_tol=1e-3)
    assert math.isclose(flops, 131.79e12, rel_tol=1e-3)
    assert math.isclose(sum(w.flops for w in total if w.kind == "attn"), 0.02444 * flops,
                        rel_tol=1e-3)
