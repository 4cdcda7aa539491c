"""The CIFAR and MNIST apps trained data-parallel on the CPU, over gloo
ranks: ``cifar_app.main([... '--mesh_devices', '2', ...], device='cpu')``
spawning its own ranks (JAX's batch and iterations under
``--multi_gpu_multi_batch``, one run dir written, by rank 0, the returned
state and the checkpoint alike), and ``mnist_app.main`` the same way; both
apps inside a group that
:func:`~rcgan_tpu_torch.parallel.mesh.launch` started (as under
``torchrun``): the ranks end bit-equal, a run killed by
``RCGAN_FAULT_AT_STEP`` and resumed with ``--restore`` (CIFAR) or restored
from its checkpoint (MNIST) gives the uninterrupted run's bits; and more
ranks than cards raise before anything is written.

Rank functions are module-level (a spawned rank imports this module, which
imports no JAX); inside a launched rank the eval classifier is narrowed
(CIFAR) or the model narrowed (MNIST) as the single-device app tests do.
"""

import os
import pickle

import pytest
import torch

from rcgan_tpu_torch.apps import cifar_app, mnist_app
from rcgan_tpu_torch.train.checkpoint import Checkpointer, state_payload

torch.set_num_threads(min(2, torch.get_num_threads()))

TIMEOUT = 600.0
CIFAR_ARGS = ["--alpha", "0.6", "--batch_size", "8", "--dim_g", "8", "--dim_d", "16",
              "--embedding_dim", "12", "--n_critic", "2", "--inception_freq", "1000000",
              "--generated_label_accuracy_freq", "1000000", "--eval_train_size", "16",
              "--compute_dtype", "float32", "--synthetic_train_size", "96",
              "--multi_gpu_multi_batch"]


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    monkeypatch.delenv("RCGAN_FAULT_AT_STEP", raising=False)
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def _flat(payload: dict) -> dict:
    flat = {f"g/{g}/{k}": v for g, d in payload["groups"].items() for k, v in d.items()}
    flat.update({f"s/{k}": v for k, v in payload["state"].items()})
    for g, st in payload["opt_states"].items():
        flat.update({f"{m}/{g}/{k}": v for m in ("mu", "nu") for k, v in st[m].items()})
        flat[f"count/{g}"] = torch.tensor(st["count"])
    flat["step"] = torch.tensor(payload["step"])
    return flat


def _assert_same_bits(a: dict, b: dict, label: str):
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b), label
    for k in a:
        assert torch.equal(a[k], b[k]), (label, k)


def test_cifar_app_spawns_its_ranks(tmp_path):
    """Two ranks spawned by the app on the CPU: batch 8 doubled to 16 and
    iterations 4 halved to 2 under ``--multi_gpu_multi_batch``, as JAX's
    ``build_configs``; one timestamped run dir (rank 0's, its name
    broadcast), its log, ``log.pkl`` and sample grid; the returned state is
    rank 0's and equals its last checkpoint, restored."""
    log_file = str(tmp_path / "log.txt")
    ts, acc = cifar_app.main(
        ["--algorithm", "rcgan", "--run", "p", "--parent_dir", str(tmp_path), "--log_file",
         log_file, "--niters", "4", "--sample_freq", "2", "--ckpt_early_every", "1",
         "--mesh_devices", "2", "--data_dir", str(tmp_path / "data")] + CIFAR_ARGS,
        device="cpu")
    assert ts.step == 2 and 0.0 <= acc <= 1.0
    text = open(log_file).read()
    assert "device cpu; 2 device(s); batch 16; iters 2" in text
    assert "final generated label accuracy" in text
    runs = [d for d in os.listdir(tmp_path) if d.startswith("rcgan_alpha0.6_run-p_")]
    assert len(runs) == 1, os.listdir(tmp_path)
    run = tmp_path / runs[0]
    assert {"checkpoint", "samples_1.png", "log.pkl", "config.json"} <= set(os.listdir(run))
    with open(run / "log.pkl", "rb") as f:
        assert sorted(pickle.load(f)["d_cost"]) == [0, 1]
    ck = Checkpointer(str(run / "checkpoint"))
    assert ck.steps() == [0, 1]
    _assert_same_bits(ck.read()[1], state_payload(ts), "checkpoint 1")


def _cifar_rank(group, argv, fault_at):
    """``cifar_app.main`` inside the launched group, its eval classifier at
    width 8; returns ``("ok", state, acc)`` or ``("raised", message)``."""
    from rcgan_tpu_torch.evals import classifier as tcls

    cifar_app.cifar_classifier = lambda device: tcls.cifar_classifier(dim=8, device=device)
    os.environ.pop("RCGAN_FAULT_AT_STEP", None)
    if fault_at is not None:
        os.environ["RCGAN_FAULT_AT_STEP"] = str(fault_at)
    try:
        ts, acc = cifar_app.main(argv, device=str(group.device))
    except RuntimeError as e:
        return ("raised", str(e))
    return ("ok", state_payload(ts), acc)


def test_cifar_app_in_a_launched_group_resumes_to_the_same_bits(tmp_path):
    """rcgan-u with the perm classifier, 12 iterations halved to 6 over two
    ranks, a checkpoint every second early iteration.  Both ranks end
    bit-equal and only rank 0 returns the accuracy; the run killed at
    iteration 4 leaves checkpoints 0 and 2 and, resumed with ``--restore``
    (iteration 3 begins an epoch of the 96-image split: 6 batches of 16, 2
    critic and 2 generator batches an iteration), ends with the
    uninterrupted run's bits on both ranks."""
    common = ["--algorithm", "rcgan-u", "--perm_classifier", "--confuse_init", "--niters",
              "12", "--sample_freq", "1000000", "--ckpt_early_every", "2", "--mesh_devices",
              "2", "--parent_dir", str(tmp_path), "--data_dir", str(tmp_path / "data")]
    common += CIFAR_ARGS

    def run(expt, fault_at=None, *extra):
        argv = common + ["--expt_dir", expt, "--log_file", str(tmp_path / f"{expt}.txt"), *extra]
        return cifar_app_ranks(argv, fault_at)

    whole = run("whole")
    assert [r[0] for r in whole] == ["ok", "ok"]
    assert whole[0][2] is not None and whole[1][2] is None
    _assert_same_bits(whole[0][1], whole[1][1], "ranks")
    assert whole[0][1]["step"] == 6
    killed = run("killed", 4)
    assert all(r[0] == "raised" and "injected fault at step 4" in r[1] for r in killed)
    ck = tmp_path / "killed" / "checkpoint"
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["0", "2"]
    resumed = run("killed", None, "--restore")
    assert "restored from step 3" in open(tmp_path / "killed.txt").read()
    for r in range(2):
        _assert_same_bits(resumed[r][1], whole[0][1], f"resumed rank {r}")
    assert {d for d in os.listdir(tmp_path) if (tmp_path / d / "config.json").exists()} == {
        "whole", "killed"}


def cifar_app_ranks(argv, fault_at):
    from rcgan_tpu_torch.parallel import launch

    return launch(_cifar_rank, 2, backend="gloo", args=(argv, fault_at), timeout=TIMEOUT)


MNIST_APP = ["--algorithm", "rcgan", "--alpha", "0.3", "--disc_type", "projection",
             "--estimate_confuse", "--aux_classifier", "--noadd_noise", "--noconcat_y",
             "--spectral_norm", "--max_norm", "--batch_size", "20", "--train_size", "200",
             "--epoch", "5", "--recover_epoch", "2", "--recover_batch_size", "20",
             "--eval_train_size", "512", "--compute_dtype", "float32", "--mesh_devices", "2"]


def _mnist_rank(group, argv):
    """``mnist_app.main`` in the launched group at the test widths
    (``tests/test_torch_mnist_app.py``'s ``small_app``)."""
    import dataclasses

    from torch_parity import TINY_MNIST

    build = mnist_app.build_configs

    def narrow(flags):
        cfg, acfg, tcfg = build(flags)
        return dataclasses.replace(cfg, **TINY_MNIST), acfg, tcfg

    mnist_app.build_configs = narrow
    ts, rec = mnist_app.main(argv, device=str(group.device))
    return state_payload(ts), rec


def test_mnist_app_in_a_launched_group(tmp_path):
    """Two ranks, 5 epochs of 10 iterations of the global batch of 20 (10
    rows a rank), stepped iteration by iteration: one run dir with its
    checkpoint, samples, recovery and log; the ranks end bit-equal, rank 0
    alone returns the recovery; then the run restored without ``--train``
    on two ranks gives the same bits and the same recovery."""
    from rcgan_tpu_torch.parallel import launch

    paths = ["--checkpoint_dir", str(tmp_path), "--data_dir", str(tmp_path / "data"),
             "--logs_dir", str(tmp_path / "logs")]
    out = launch(_mnist_rank, 2, backend="gloo", args=(MNIST_APP + ["--train"] + paths,),
                 timeout=TIMEOUT)
    _assert_same_bits(out[0][0], out[1][0], "ranks")
    assert out[0][0]["step"] == 50 and out[1][1] is None
    assert 0.0 <= out[0][1]["accuracy"] <= 1.0
    runs = [d for d in os.listdir(tmp_path) if d.startswith("rcgan_0.3_projection_")]
    assert len(runs) == 1, os.listdir(tmp_path)
    run = tmp_path / runs[0]
    assert {"ckpt", "samples", "recovery.txt", "recover_wrong_images.png", "log.pkl",
            "config.json"} <= set(os.listdir(run))
    assert sorted(os.listdir(run / "ckpt"), key=int)[-1] == "50"
    again = launch(_mnist_rank, 2, backend="gloo",
                   args=(MNIST_APP + ["--checkpoint", runs[0]] + paths,), timeout=TIMEOUT)
    for r in range(2):
        _assert_same_bits(again[r][0], out[0][0], f"restored rank {r}")
    assert again[0][1]["accuracy"] == out[0][1]["accuracy"]


@pytest.mark.parametrize("app", ["cifar", "mnist"])
def test_more_ranks_than_cards_raise(app, tmp_path, monkeypatch):
    """``--mesh_devices 2`` on a machine with one card raises before the
    app writes anything; the CPU takes any number of gloo ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    main = cifar_app.main if app == "cifar" else mnist_app.main
    argv = (["--parent_dir", str(tmp_path), "--log_file", str(tmp_path / "l.txt")]
            if app == "cifar" else ["--checkpoint_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="2 devices asked for; 1 card"):
        main(argv + ["--mesh_devices", "2", "--data_dir", str(tmp_path / "data")],
             device="cuda")
    assert os.listdir(tmp_path) == []


def test_mnist_app_spawns_its_ranks(tmp_path):
    """``mnist_app.main([... '--mesh_devices', '2'], device='cpu')`` at the
    app's own widths, cut to 2 iterations of the global batch of 20: the
    app spawns two ranks, one run dir is written, and the returned state is
    rank 0's last checkpoint."""
    argv = ["--algorithm", "rcgan", "--alpha", "0.3", "--disc_type", "projection",
            "--noestimate_confuse", "--noaux_classifier", "--noadd_noise", "--noconcat_y",
            "--spectral_norm", "--max_norm", "--train", "--epoch", "1", "--train_size", "40",
            "--batch_size", "20", "--recover_epoch", "1", "--recover_batch_size", "20",
            "--eval_train_size", "64", "--compute_dtype", "float32", "--mesh_devices", "2",
            "--checkpoint_dir", str(tmp_path), "--data_dir", str(tmp_path / "data"),
            "--logs_dir", str(tmp_path / "logs")]
    ts, rec = mnist_app.main(argv, device="cpu")
    assert ts.step == 2 and 0.0 <= rec["accuracy"] <= 1.0
    runs = [d for d in os.listdir(tmp_path) if d.startswith("rcgan_0.3_projection_")]
    assert len(runs) == 1, os.listdir(tmp_path)
    ck = Checkpointer(str(tmp_path / runs[0] / "ckpt"))
    assert ck.steps()[-1] == 2
    _assert_same_bits(ck.read()[1], state_payload(ts), "checkpoint 2")
