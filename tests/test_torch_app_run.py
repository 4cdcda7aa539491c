"""The port's CIFAR app end to end on the CPU, at tiny widths: the run dir
the JAX app writes, the rcgan-u evals and the final accuracy lines, the
block path against the per-cycle path, and a run killed by
``RCGAN_FAULT_AT_STEP`` and resumed with ``--restore`` against the
uninterrupted run, bit for bit.

The eval classifier is narrowed to width 8 here (the app's is 64) and
trained on too few images for a batch, so the evals cost little; its
logits are held to JAX's at full structure by ``test_torch_app_evals.py``.
"""

import os

import numpy as np
import pytest
import torch

from rcgan_tpu_torch.apps import cifar_app
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.train.checkpoint import state_payload

torch.set_num_threads(min(2, torch.get_num_threads()))

# the JAX app test's tiny run (tests/test_apps.py), widths as the port's
# parity tests (dim_d 16); each test adds ``--data_dir`` (``_data``)
TINY_ARGS = ["--alpha", "0.6", "--batch_size", "8", "--dim_g", "8", "--dim_d", "16",
             "--embedding_dim", "12", "--n_critic", "2", "--inception_freq", "1000000",
             "--mesh_devices", "1", "--nomulti_gpu_multi_batch", "--eval_train_size", "16",
             "--compute_dtype", "float32"]


def _data(tmp_path):
    """A data dir inside the test's own ground that does not exist, so
    ``load`` takes the synthetic split whatever lies around the checkout."""
    return ["--data_dir", str(tmp_path / "data")]


@pytest.fixture(autouse=True)
def _small_evals(monkeypatch, tmp_path):
    monkeypatch.setenv("RCGAN_SYNTH_CACHE", str(tmp_path / "synth"))
    monkeypatch.delenv("RCGAN_FAULT_AT_STEP", raising=False)
    monkeypatch.setattr(cifar_app, "cifar_classifier",
                        lambda device: tcls.cifar_classifier(dim=8, device=device))


def test_app_end_to_end_writes_the_jax_run_dir(tmp_path):
    """rcgan-u with the perm classifier, ``confuse_init`` and the corrected
    accuracy, two cycles, evals every second iteration: the JAX app test's
    run, on the CPU.  The run dir holds what JAX's holds (checkpoint/,
    samples_1.png, log.pkl, metrics.jsonl, command.txt, config.json, the
    archived sources), the log the learned-C recovery, raw and corrected
    accuracies and the final line; the learned confusion logits are in the
    state."""
    log_file = str(tmp_path / "log.txt")
    stats = {}
    ts, acc = cifar_app.main(
        ["--algorithm", "rcgan-u", "--run", "t", "--log_file", log_file, "--parent_dir",
         str(tmp_path), "--niters", "2", "--sample_freq", "2",
         "--generated_label_accuracy_freq", "2", "--perm_classifier", "--confuse_init",
         "--perm_gen_label_acc", "--synthetic_train_size", "64"] + TINY_ARGS + _data(tmp_path),
        device="cpu", stats=stats)
    assert 0.0 <= acc <= 1.0 and ts.step == 2
    text = open(log_file).read()
    for line in ("learned-C recovery", "gen-label-acc raw",
                 "final raw (uncorrected) generated label accuracy",
                 "final generated label accuracy"):
        assert line in text
    runs = [d for d in os.listdir(tmp_path) if d.startswith("rcgan-u_alpha0.6_run-t_")]
    assert len(runs) == 1
    run = tmp_path / runs[0]
    names = set(os.listdir(run))
    assert {"checkpoint", "samples_1.png", "log.pkl", "metrics.jsonl", "command.txt",
            "config.json", "scripts"} <= names
    assert (run / "checkpoint" / "0" / "train_state.pt").exists()
    assert not list((run / "scripts").rglob("*.so"))
    assert ("confusion_logits", "logits") in ts.groups["confusion"]
    assert stats["train"][1] == 2 and stats["dev_cost"][1] == 1 and stats["samples"][1] == 1


def _bits(ts):
    p = state_payload(ts)
    flat = {f"g/{g}/{k}": v for g, d in p["groups"].items() for k, v in d.items()}
    flat.update({f"s/{k}": v for k, v in p["state"].items()})
    for g, st in p["opt_states"].items():
        flat.update({f"{m}/{g}/{k}": v for m in ("mu", "nu") for k, v in st[m].items()})
        flat[f"count/{g}"] = torch.tensor(st["count"])
    flat["step"] = torch.tensor(p["step"])
    return flat


def _assert_same_bits(a, b):
    a, b = _bits(a), _bits(b)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_after_an_injected_fault_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """rcgan, 6 iterations in blocks of 3, a checkpoint every second early
    iteration.  The run killed at iteration 4 (``RCGAN_FAULT_AT_STEP``)
    leaves checkpoint 2; restarted with ``--restore`` it resumes at
    iteration 3 and ends with every parameter, SN ``u``, Adam moment and
    count and the step equal, bit for bit, to the uninterrupted run.  Like
    JAX's, the restarted batch iterators begin at position 0 of the split:
    the split here holds 6 batches, and each iteration takes 2 critic and 2
    generator batches, so iteration 3 begins an epoch in both runs (what a
    resume from another position would draw differs, as in JAX).  The
    per-cycle path (``--scan_block 1``) gives the same bits as the blocks."""
    common = ["--algorithm", "rcgan", "--niters", "6", "--sample_freq", "1000000",
              "--generated_label_accuracy_freq", "1000000", "--synthetic_train_size", "48",
              "--ckpt_early_every", "2", "--parent_dir", str(tmp_path),
              *_data(tmp_path)] + TINY_ARGS

    def run(expt, *extra):
        return cifar_app.main(common + ["--expt_dir", expt, "--log_file",
                                        str(tmp_path / f"{expt}.txt"), *extra], device="cpu")

    whole, _ = run("whole", "--scan_block", "3")
    monkeypatch.setenv("RCGAN_FAULT_AT_STEP", "4")
    with pytest.raises(RuntimeError, match="injected fault at step 4"):
        run("killed", "--scan_block", "3")
    ck = tmp_path / "killed" / "checkpoint"
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["0", "2"]
    monkeypatch.delenv("RCGAN_FAULT_AT_STEP")
    resumed, _ = run("killed", "--scan_block", "3")
    assert "restored from step 3" in open(tmp_path / "killed.txt").read()
    _assert_same_bits(resumed, whole)
    assert sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit()) == [0, 2, 4]
    per_cycle, _ = run("per_cycle", "--scan_block", "1")
    _assert_same_bits(per_cycle, whole)


def test_app_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Two devices on a machine with one card raise instead of running with
    less (two ranks on the CPU run: ``tests/test_torch_parallel_app.py``).
    Inception-v3 weights in the data dir are taken now, and a file that is
    not a whole Inception-v3 is refused on load, as in JAX."""
    base = ["--algorithm", "rcgan", "--parent_dir", str(tmp_path), "--expt_dir", "x",
            "--log_file", str(tmp_path / "l.txt"), "--niters", "1"] + _data(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 devices asked for; 1 card"):
            cifar_app.main(base + ["--mesh_devices", "2"], device="cuda")
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "inception_v3.npz", w=np.zeros(1))
    with pytest.raises(ValueError, match="inception_v3 weights missing"):
        cifar_app.main(base + ["--mesh_devices", "1"], device="cpu")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``--profile_steps``' hook: ``utils.profiling.trace`` writes the traced
    block as ``trace.json`` (on the CPU here, the card too where there is
    one)."""
    from rcgan_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "p")):
        torch.ones(8).sum()
    assert (tmp_path / "p" / "trace.json").stat().st_size > 0
