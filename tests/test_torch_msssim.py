"""The port's MS-SSIM (``evals/msssim.py``), its PNG decoder
(``utils/images.py::decode_png``) and its diversity report
(``evals/msssim_report.py``) on the CPU, against the JAX package's
``rcgan_tpu/evals/msssim.py``, PIL and ``scripts/msssim_report.py``.

float32 on both sides, depthwise VALID convs in other summation orders:
1e-5 (absolute; SSIM values lie in [-1, 1])."""

import contextlib
import importlib.util
import io
import json
import pathlib
import struct
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from PIL import Image

from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu_torch.data.confusion import one_coin_matrix
from rcgan_tpu_torch.evals import msssim as tms
from rcgan_tpu_torch.evals import msssim_report as treport
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.serving import Sampler
from rcgan_tpu_torch.train.checkpoint import Checkpointer
from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.utils.images import decode_png, encode_png

# rcgan_tpu.evals exports the function msssim under the module's name
jms = importlib.import_module("rcgan_tpu.evals.msssim")

torch.set_num_threads(min(2, torch.get_num_threads()))

_ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _pairs(shape, seed: int, similar: bool = True):
    """Image pairs in [0, 255]: the second a noisy copy of the first (or
    independent)."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rs.normal(0, 30, shape), 0, 255) if similar else rs.uniform(0, 255, shape)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (3, 37, 29, 1), (2, 16, 16, 3)])
def test_ssim_and_msssim_match_jax(shape):
    """``ssim_per_image``, ``ssim``, ``msssim`` and ``msssim_pairs`` against
    JAX's, on a 32x32 batch, odd sizes (the crop before each 2x2 mean) and
    maps smaller than the 11-tap window; identical pairs give 1."""
    for similar in (True, False):
        a, b = _pairs(shape, sum(shape) + similar, similar)
        s, cs = tms.ssim_per_image(a, b, device="cpu")
        js, jcs = jms.ssim_per_image(jnp.asarray(a), jnp.asarray(b))
        assert s.dtype == torch.float32 and s.shape == (shape[0],)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=TOL)
        np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=0, atol=TOL)
        got, want = tms.ssim(a, b, device="cpu"), jms.ssim(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose([t.item() for t in got], [float(t) for t in want], rtol=0,
                                   atol=TOL)
        assert abs(tms.msssim(a, b, device="cpu") - jms.msssim(a, b)) <= TOL
        pairs = tms.msssim_pairs(torch.from_numpy(a), torch.from_numpy(b), device="cpu")
        np.testing.assert_allclose(pairs.numpy(), np.asarray(jms.msssim_pairs(a, b)), rtol=0,
                                   atol=TOL)
        assert bool(torch.isfinite(pairs).all())
    np.testing.assert_allclose(tms.msssim_pairs(a, a, device="cpu").numpy(), 1.0, atol=TOL)
    assert tms.msssim(a, a, device="cpu") == pytest.approx(1.0, abs=TOL)


def test_msssim_keyword_arguments_and_device_default():
    """``max_val`` and the SSIM constants pass through as in JAX; without a
    card the default device raises."""
    a, b = _pairs((2, 16, 16, 3), 3)
    a, b = a / 255.0, b / 255.0
    s, cs = tms.ssim_per_image(a, b, max_val=1.0, filter_size=5, filter_sigma=1.0, k1=0.02,
                               device="cpu")
    js, jcs = jms.ssim_per_image(a, b, max_val=1.0, filter_size=5, filter_sigma=1.0, k1=0.02)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=0, atol=TOL)
    assert abs(tms.msssim(a, b, max_val=1.0, device="cpu") - jms.msssim(a, b, max_val=1.0)) <= TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tms.msssim(a, b)


def test_cli_on_pngs_written_by_encode_png(tmp_path, capsys):
    """The CLI decodes both PNGs (RGB, and grey taken as RGB) and prints
    JAX's MS-SSIM of the same pixels."""
    a, b = (x.astype(np.uint8) for x in _pairs((1, 48, 40, 3), 7))
    (tmp_path / "a.png").write_bytes(encode_png(a[0]))
    (tmp_path / "b.png").write_bytes(encode_png(b[0]))
    (tmp_path / "g.png").write_bytes(encode_png(b[0, :, :, 0]))
    tms._main(["--original_image", str(tmp_path / "a.png"), "--compared_image",
               str(tmp_path / "b.png"), "--device", "cpu"])
    got = float(capsys.readouterr().out)
    assert abs(got - jms.msssim(a.astype(np.float32), b.astype(np.float32))) <= TOL
    tms._main(["--original_image", str(tmp_path / "a.png"), "--compared_image",
               str(tmp_path / "g.png"), "--device", "cpu"])
    grey = np.repeat(b[:, :, :, :1], 3, axis=3).astype(np.float32)
    assert abs(float(capsys.readouterr().out) - jms.msssim(a.astype(np.float32), grey)) <= TOL
    (tmp_path / "c.png").write_bytes(encode_png(a[0, :40]))
    with pytest.raises(SystemExit, match="shapes differ"):
        tms._main(["--original_image", str(tmp_path / "a.png"), "--compared_image",
                   str(tmp_path / "c.png"), "--device", "cpu"])


# ------------------------------------------------------------------ decode_png
@pytest.mark.parametrize("mode,shape", [("L", (17, 23)), ("RGB", (19, 13, 3)),
                                        ("RGBA", (8, 31, 4)), ("LA", (9, 12, 2))])
def test_decode_png_reads_what_pil_writes(mode, shape):
    """PIL's encoder picks a filter per row; smooth ramps and noise make it
    use several."""
    rs = np.random.RandomState(len(shape))
    ramp = (np.arange(np.prod(shape)) % 256).reshape(shape)
    a = np.where(rs.rand(*shape) < 0.5, ramp, rs.randint(0, 256, shape)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, format="PNG")
    data = buf.getvalue()
    got = decode_png(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    np.testing.assert_array_equal(got, a)


def _filtered(a: np.ndarray, kinds) -> bytes:
    """A PNG of uint8 ``a`` ([H, W, C]) whose row y is written with PNG
    filter ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), as the
    PNG specification defines them."""
    h, w, c = a.shape
    x = a.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur, up = x[y], (x[y - 1] if y else np.zeros(w * c, np.int64))
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kinds[y] == 4:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        else:
            pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2}[kinds[y]]
        rows.append(bytes([kinds[y]]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decode_png_undoes_each_filter(kind):
    """Every row in one filter (and, for the last case, all five mixed),
    built by hand: decode_png and PIL read back the same pixels."""
    rs = np.random.RandomState(kind)
    for c in (3, 4, 1):
        a = rs.randint(0, 256, (6, 7, c)).astype(np.uint8)
        for kinds in ([kind] * 6, [kind, (kind + 1) % 5, 4, 3, 2, 1]):
            data = _filtered(a, kinds)
            got = decode_png(data)
            np.testing.assert_array_equal(got.reshape(a.shape), a)
            np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))


def test_decode_png_refuses_what_it_does_not_decode():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


# ------------------------------------------------------------------ the report
def _jax_report_module():
    spec = importlib.util.spec_from_file_location("msssim_report", _ROOT / "scripts" /
                                                  "msssim_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_report_helpers_match_the_jax_script(tmp_path, monkeypatch):
    """The real pools are the same renders, and the per-class means over
    the same pair draws agree with the JAX script's."""
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    jr = _jax_report_module()
    imgs, labels = treport._real_images("cifar", 0, 256)
    jimgs, jlabels = jr._real_images("cifar", 0, 256)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    got = treport._per_class_mean(imgs, labels, 8, 12, np.random.RandomState(5), "cpu")
    want = jr._per_class_mean(jimgs, jlabels, 8, 12, np.random.RandomState(5))
    for c in range(10):
        assert got[c]["n_images"] == want[c]["n_images"] and got[c]["n_pairs"] == 12
        np.testing.assert_allclose([got[c]["mean"], got[c]["std"]],
                                   [want[c]["mean"], want[c]["std"]], rtol=0, atol=TOL)


def test_report_end_to_end_on_a_port_checkpoint(tmp_path, monkeypatch):
    """``python -m rcgan_tpu_torch.evals.msssim_report`` on a tiny CIFAR
    app checkpoint: JAX's report keys, and every number equal to the JAX
    script's protocol run on the same generated and real pools."""
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    cfg = dict(dim_g=8, dim_d=8, embedding_dim=12, algorithm="rcgan")
    tr = CifarTrainer(ResnetGANConfig(**cfg), CifarAlgoConfig(), CifarTrainConfig(),
                      one_coin_matrix(0.6, 10), device="cpu")
    ckpt = tmp_path / "run" / "checkpoint"
    Checkpointer(str(ckpt)).save(0, tr.init(), wait=True)
    (tmp_path / "run" / "config.json").write_text(json.dumps(cfg))
    argv = ["--checkpoint_dir", str(ckpt), "--per_class", "4", "--pairs", "6",
            "--real_pool", "256", "--seed", "3", "--device", "cpu",
            "--out", str(tmp_path / "out" / "msssim.json")]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        report = treport.main(argv)
    assert json.loads(out.getvalue().splitlines()[0]) == report
    assert json.loads((tmp_path / "out" / "msssim.json").read_text()) == report
    assert set(report) == {"model", "checkpoint_dir", "per_class", "pairs", "seed", "generated",
                           "real", "generated_mean", "real_mean", "max_class_gap", "protocol"}

    jr = _jax_report_module()
    sampler = Sampler.from_checkpoint("cifar", str(ckpt), device="cpu")
    gen = np.concatenate([sampler.sample([c] * 4, torch.Generator().manual_seed(3000 + c))
                          for c in range(10)])
    rs = np.random.RandomState(3)
    want_gen = jr._per_class_mean((gen + 1.0) * 127.5, np.repeat(np.arange(10), 4), 4, 6, rs)
    want_real = jr._per_class_mean(*jr._real_images("cifar", 0, 256), 4, 6, rs)
    for key, want in (("generated", want_gen), ("real", want_real)):
        for c in range(10):
            np.testing.assert_allclose(report[key][str(c)]["mean"], want[c]["mean"], rtol=0,
                                       atol=TOL)
    assert 0.0 <= report["real_mean"] <= 1.0 and report["max_class_gap"] >= 0.0
