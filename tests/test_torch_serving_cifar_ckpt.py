"""The CIFAR sampler on the port's own checkpoints: a tiny port CIFAR app run
(rcgan, and rcgan-u with the perm classifier), then
``Sampler.from_checkpoint('cifar', <run>/checkpoint)``, whose template the
run's ``config.json`` (or ``--algorithm``) decides, as JAX's sampler builds
its own (``rcgan_tpu/serving.py:104-119,161-165``).  Its images are bit for
bit ``CifarTrainer.sample`` on the restored state.  A directory with neither
a checkpoint nor ``generator.npz`` raises ``FileNotFoundError``; the
``generator.npz`` route is held by ``test_torch_serving.py``'s
``test_export_script_and_from_checkpoint``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from rcgan_tpu_torch import serving
from rcgan_tpu_torch.apps import cifar_app
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.train.checkpoint import Checkpointer, load_payload

torch.set_num_threads(min(2, torch.get_num_threads()))

TINY = ["--alpha", "0.6", "--batch_size", "8", "--dim_g", "8", "--dim_d", "16",
        "--embedding_dim", "12", "--n_critic", "2", "--inception_freq", "1000000",
        "--sample_freq", "1000000", "--generated_label_accuracy_freq", "1000000",
        "--mesh_devices", "1", "--nomulti_gpu_multi_batch", "--eval_train_size", "16",
        "--compute_dtype", "float32", "--synthetic_train_size", "48", "--niters", "2",
        "--ckpt_early_every", "1"]
MODES = {"rcgan": ["--algorithm", "rcgan"],
         "rcgan-u": ["--algorithm", "rcgan-u", "--perm_classifier", "--confuse_init"]}


@pytest.fixture
def run_of(monkeypatch, tmp_path):
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    monkeypatch.delenv("RCGAN_FAULT_AT_STEP", raising=False)
    monkeypatch.setattr(cifar_app, "cifar_classifier",
                        lambda device: tcls.cifar_classifier(dim=8, device=device))

    def run(mode):
        argv = MODES[mode] + TINY + ["--parent_dir", str(tmp_path), "--expt_dir", mode,
                                     "--log_file", str(tmp_path / f"{mode}.txt"),
                                     "--data_dir", str(tmp_path / "data")]
        cifar_app.main(argv, device="cpu")
        flags = cifar_app.flagslib.parse(cifar_app.flagslib.cifar_flags(), argv)
        cfg, acfg, tcfg, _, _ = cifar_app.build_configs(flags, 1)
        trainer = cifar_app.CifarTrainer(cfg, acfg, tcfg, cifar_app.one_coin_matrix(0.6, 10),
                                         device="cpu")
        return tmp_path / mode / "checkpoint", trainer

    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampler_serves_the_apps_checkpoint(run_of, mode):
    """The newest checkpoint (step 1 of 0 and 1), restored into the
    template of the run's algorithm: the confusion group for rcgan-u, the
    perm classifier with it; ``sample_with_z`` at a bucket's size equals
    ``CifarTrainer.sample`` on that state, bit for bit."""
    ckpt, trainer = run_of(mode)
    s = serving.Sampler.from_checkpoint("cifar", str(ckpt), buckets=(8,), device="cpu")
    assert s.model == "cifar" and s.cfg.dim_g == 8 and s.cfg.algorithm == mode
    assert next(s.generator.parameters()).dtype == torch.float32
    ts = trainer.init()
    step, payload = Checkpointer(str(ckpt)).read()
    assert step == 1
    load_payload(ts, payload)
    assert ("confusion" in ts.groups) == (mode == "rcgan-u")
    for (la, var), p in ts.groups["gen"].items():
        assert torch.equal(getattr(s.generator.get_submodule(_path(s.generator, la)), var), p)
    z = np.random.RandomState(5).randn(8, 128).astype(np.float32)
    labels = [0, 1, 2, 3, 4, 5, 6, 9]
    want = trainer.sample(ts, z, labels).reshape(-1, 32, 32, 3).numpy()
    np.testing.assert_array_equal(s.sample_with_z(z, labels), want)


def _path(module, scope):
    """The attribute path of the layer whose JAX scope is ``scope``."""
    return next(n for n, m in module.named_modules() if getattr(m, "scope", None) == scope)


def test_algorithm_flag_routes_the_template(run_of, tmp_path):
    """An rcgan-u checkpoint read as rcgan has a group the template lacks
    and is refused; ``--algorithm`` on the CLI is passed through as JAX's
    is, and the run's own algorithm serves a grid."""
    ckpt, _ = run_of("rcgan-u")
    with pytest.raises(KeyError, match="groups"):
        serving.Sampler.from_checkpoint("cifar", str(ckpt), device="cpu", algorithm="rcgan")
    with pytest.raises(KeyError, match="groups"):
        serving.main(["--model", "cifar", "--checkpoint_dir", str(ckpt), "--algorithm",
                      "rcgan", "--device", "cpu", "--n", "4", "--out", str(tmp_path / "x.png")])
    png = tmp_path / "grid.png"
    serving.main(["--model", "cifar", "--checkpoint_dir", str(ckpt), "--algorithm", "rcgan-u",
                  "--device", "cpu", "--n", "4", "--out", str(png)])
    assert Image.open(png).size == (64, 64)


def test_neither_checkpoint_nor_export_raises(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for d in (empty, tmp_path / "absent"):
        with pytest.raises(FileNotFoundError, match="no checkpoint of a CIFAR app run and no "
                                                    "generator.npz"):
            serving.Sampler.from_checkpoint("cifar", str(d), device="cpu")
    assert not os.path.exists(tmp_path / "absent")
