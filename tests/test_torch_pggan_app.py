"""The port's PGGAN app and sampler on the CPU, at JAX's end-to-end test
size (``tests/test_pggan.py::test_pggan_app_end_to_end``: ``--size 16``,
``max_stage`` 2, dim 8, batch 8, 2 + 2 + 2 iterations): the eval rows,
sample grids, ``stage_accuracy.json`` and the pinned classifier's cache;
a second run with ``--resume`` that takes no step and keeps the rows; the
PGGAN ``Sampler`` on the run's checkpoint against ``trainer.sample``, over
HTTP, and the CLI's grid.

The eval classifier is narrowed to width 8 (the app's is 64), so the
evals cost little; ``tests/test_torch_app_evals.py`` holds its logits to
JAX's at full structure.
"""

import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from rcgan_tpu_torch import serving
from rcgan_tpu_torch.apps import pggan_app
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.models.pggan import PGGANConfig
from rcgan_tpu_torch.models.resnet_gan import ResnetGANConfig
from rcgan_tpu_torch.train.checkpoint import Checkpointer, state_payload
from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer

torch.set_num_threads(min(2, torch.get_num_threads()))

ARGS = ["--size", "16", "--max_stage", "2", "--dim", "8", "--z_dim", "8", "--batch_size", "8",
        "--trans_iters", "2", "--stab_iters", "2", "--train_size", "200",
        "--eval_samples", "8", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The app's run (and its stats), then the same run dir again with
    ``--resume``."""
    root = tmp_path_factory.mktemp("pg")
    mp = pytest.MonkeyPatch()
    mp.setenv("RCGAN_SYNTH_CACHE", str(root / "synth"))
    mp.setattr(pggan_app, "cifar_classifier",
               lambda img_size, device: tcls.cifar_classifier(dim=8, img_size=img_size,
                                                              device=device))
    try:
        run_dir = str(root / "pg")
        stats = {}
        ts, rows = pggan_app.main(["--run_dir", run_dir] + ARGS, device="cpu", stats=stats)
        bits = state_payload(ts)
        stats2 = {}
        ts2, rows2 = pggan_app.main(["--run_dir", run_dir] + ARGS, device="cpu", stats=stats2)
    finally:
        mp.undo()
    return root, run_dir, (ts, rows, stats, bits), (ts2, rows2, stats2)


def test_app_end_to_end_writes_rows_grids_and_the_classifier(run):
    """Three phases, three rows (stages 1, 2, 2), each accuracy in [0, 1];
    a 10x10 grid per phase at the stage's resolution; ``config.json``;
    phase checkpoints at 2, 4, 6; the classifier cached in the run dir's
    parent under the data-keyed name."""
    root, run_dir, (ts, rows, stats, _), _ = run
    assert ts.step == 6
    assert [(r["stage"], r["res"], r["trans"], r["iter"]) for r in rows] == [
        (1, 8, False, 2), (2, 16, True, 4), (2, 16, False, 6)]
    assert all(0.0 <= r["gen_label_acc"] <= 1.0 for r in rows)
    with open(os.path.join(run_dir, "stage_accuracy.json")) as f:
        assert json.load(f) == rows
    for name, side in (("samples_stage1_stab.png", 80), ("samples_stage2_trans.png", 160),
                       ("samples_stage2_stab.png", 160)):
        assert Image.open(os.path.join(run_dir, name)).size == (side, side)
    assert json.load(open(os.path.join(run_dir, "config.json")))["max_stage"] == 2
    assert Checkpointer(os.path.join(run_dir, "ckpt")).steps() == [2, 4, 6]
    assert os.path.exists(root / "eval_classifier_16_s0_n200.pkl")
    assert stats["train"][1] == 6 and stats["eval"][1] == 3 and stats["checkpoint_save"][1] == 3


def test_resume_takes_no_step_and_keeps_the_rows(run):
    """The same command again resumes from the phase checkpoint at 6: no
    step, the state bit-equal, the rows read back."""
    _, _, (ts, rows, _, bits), (ts2, rows2, stats2) = run
    assert ts2.step == 6 and rows2 == rows
    again = state_payload(ts2)
    assert all(torch.equal(a, again["groups"][g][k]) for g in bits["groups"]
               for k, a in bits["groups"][g].items())
    assert all(torch.equal(a, again["state"][k]) for k, a in bits["state"].items())
    assert stats2["restore"][1] == 1 and stats2["train"][1] == 0


def test_app_refuses_a_size_off_the_schedule(tmp_path):
    with pytest.raises(ValueError, match="4\\*2\\^max_stage"):
        pggan_app.main(["--run_dir", str(tmp_path), "--size", "32", "--max_stage", "2"],
                       device="cpu")


def test_sampler_serves_the_run_as_the_trainer_samples(run):
    """``Sampler.from_checkpoint("pggan", <run>/ckpt)`` reads the run's
    config: NHWC at 16x16 in [-1, 1], bit-equal to ``trainer.sample`` on the
    restored state at the same bucket; ragged requests pad to a bucket; the
    HTTP endpoint gives a PNG grid of 16-pixel tiles; the CLI writes its
    grid and, with ``--export``, its bucket-100 program."""
    root, run_dir, (ts, _, _, _), _ = run
    ckpt = os.path.join(run_dir, "ckpt")
    s = serving.Sampler.from_checkpoint("pggan", ckpt, buckets=(2, 8), device="cpu")
    assert s.model == "pggan" and s.n_labels == 10 and s.z_dim == 8
    tr = PGGANTrainer(PGGANConfig(z_dim=8, dim=8, max_stage=2),
                      ResnetGANConfig(dim_g=8, dim_d=8, z_dim=8), PGGANTrainConfig(),
                      device="cpu")
    ref_ts = Checkpointer(ckpt).restore(tr.init())
    z = np.random.RandomState(4).randn(8, 8).astype(np.float32)
    labels = np.arange(8) % 10
    got = s.sample_with_z(z, labels)
    assert got.shape == (8, 16, 16, 3) and np.abs(got).max() <= 1.0
    np.testing.assert_array_equal(got, tr.sample(ref_ts, z, labels).numpy())
    assert s.sample([1, 2, 3]).shape == (3, 16, 16, 3)

    srv = serving.make_server(s, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/sample?labels=1,2,3&seed=5"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.status == 200
            assert Image.open(io.BytesIO(r.read())).size == (32, 32)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)

    out = root / "grid.png"
    serving.main(["--model", "pggan", "--checkpoint_dir", ckpt, "--device", "cpu",
                  "--labels", "0,1,2,3", "--out", str(out)])
    arr = np.asarray(Image.open(out))
    assert arr.shape[:2] == (32, 32) and (arr == 0).mean() < 0.2  # tanh rescaled, not clipped
    # --export writes the largest bucket's pass as a torch.export program
    from rcgan_tpu_torch.exported import load_exported

    serving.main(["--model", "pggan", "--checkpoint_dir", ckpt, "--device", "cpu",
                  "--export", str(root / "x.pt2")])
    fn = load_exported(str(root / "x.pt2"), device="cpu")
    assert fn.meta == {"model": "pggan", "bucket": 100, "z_dim": 8, "n_labels": 10}
    z = np.random.RandomState(5).randn(100, 8).astype(np.float32)
    np.testing.assert_array_equal(fn(z, np.arange(100) % 10).numpy(), serving.Sampler(
        s.generator, buckets=(100,)).sample_with_z(z, np.arange(100) % 10))
