"""The app's evals and flags in the port against the JAX package, on the
CPU: the stand-in classifier's logits on the same weights, generated-label
accuracy raw and permutation-corrected, the classifier's pinned cache in
both directions, the inception estimator, the learned-C recovery report,
and the CIFAR flags' names and defaults."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rcgan_tpu import config as jconfig
from rcgan_tpu.evals import classifier as jcls
from rcgan_tpu.evals import confusion_recovery as jrec
from rcgan_tpu.evals import inception as jinc
from rcgan_tpu_torch import config as tconfig
from rcgan_tpu_torch.evals import classifier as tcls
from rcgan_tpu_torch.evals import confusion_recovery as trec
from rcgan_tpu_torch.evals import inception as tinc

torch.set_num_threads(min(2, torch.get_num_threads()))


def _jax_classifier(dim, seed=0):
    cls = jcls.cifar_classifier(dim=dim)
    cls.init(jax.random.key(seed))
    return cls


def test_cifar_resnet_logits_match_jax_on_the_same_weights():
    """JAX's initialised weights loaded into the port by name (every scope
    and var of ``cifar_resnet``), float32, on images in [-1, 1]: logits
    within 1e-4 of their scale; both trees hold the same layers."""
    jc = _jax_classifier(16)
    tc = tcls.cifar_classifier(dim=16, device="cpu")
    tc.load_params(jax.tree_util.tree_map(np.asarray, jc.params))
    assert set(tc.params) == set(jc.params) and "cls.b4.sc" in tc.params
    x = np.random.RandomState(0).uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jc.logits(jc.params, jnp.asarray(x)))
    got = tc.logits(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_generated_label_accuracy_raw_and_perm_corrected_match_jax():
    """The same weights and samples: both frameworks' predictions agree, and
    the accuracy is JAX's, raw and through the argmax-binarized learned C
    (a confusion matrix that swaps labels 0 and 1)."""
    jc = _jax_classifier(8, seed=1)
    tc = tcls.cifar_classifier(dim=8, device="cpu")
    tc.load_params(jax.tree_util.tree_map(np.asarray, jc.params))
    x = np.random.RandomState(2).uniform(-1, 1, (40, 32, 32, 3)).astype(np.float32)
    preds = tc.predict(x, batch_size=16)
    np.testing.assert_array_equal(preds, jc.predict(x, batch_size=16))
    labels = preds.copy()
    labels[::3] = (labels[::3] + 1) % 10
    cm = np.full((10, 10), 0.01)
    cm[np.arange(10), np.arange(10)] = 0.9
    cm[[0, 1]] = cm[[1, 0]]
    for c in (None, cm):
        got = tcls.generated_label_accuracy(tc, x, labels, confusion_matrix=c)
        want = jcls.generated_label_accuracy(jc, x, labels, confusion_matrix=c)
        assert got == want
    assert tcls.generated_label_accuracy(tc, x, labels) == pytest.approx(1 - 14 / 40)


def test_pinned_classifier_cache_is_shared_with_jax(tmp_path):
    """A classifier trained and pinned by the JAX package loads into the
    port (same pickle layout) and scores the same on clean data; a pinned
    cache that scores below its pin raises; the port trains and pins one
    itself (Adam on a few batches: the loss falls)."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (48, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, 48)
    jc = jcls.cifar_classifier(dim=8)
    path = str(tmp_path / "cls.pkl")
    jacc = jcls.train_pinned(jc, path, x, y, x[:16], y[:16], epochs=1, rng=jax.random.key(0))
    tc = tcls.cifar_classifier(dim=8, device="cpu")
    assert tcls.train_pinned(tc, path, x, y, x[:16], y[:16]) == pytest.approx(jacc)
    tc.meta["clean_accuracy"] = 1.5
    tc.save(path)
    with pytest.raises(RuntimeError, match="below its pin"):
        tcls.train_pinned(tcls.cifar_classifier(dim=8, device="cpu"), path, x, y, x, y)

    own = tcls.cifar_classifier(dim=8, device="cpu")
    own.init(3)
    xt, yt = torch.from_numpy(x[:16]), torch.from_numpy(y[:16])
    loss0 = torch.nn.functional.cross_entropy(own.net(xt), yt).item()
    own.train(3, x[:16], y[:16], epochs=4, batch_size=16, lr=3e-3)
    assert torch.nn.functional.cross_entropy(own.net(xt), yt).item() < loss0
    acc = tcls.train_pinned(tcls.cifar_classifier(dim=8, device="cpu"), str(tmp_path / "o.pkl"),
                            x[:8], y[:8], x[:16], y[:16], epochs=1)
    assert 0.0 <= acc <= 1.0 and (tmp_path / "o.pkl").exists()


def test_inception_estimator_matches_jax():
    """``preds_to_score`` equals JAX's on the same probabilities (one with
    an underflowed zero); ``InceptionScore`` scores uniform predictions
    1 and confident class-balanced ones 10 over 1000 samples in batches of
    100, keying each batch by ``fold_in(seed, i)`` (its seeds' device
    bases, ``batch_seeds``)."""
    p = np.random.RandomState(0).dirichlet(np.ones(10) * 0.3, 200)
    p[0, 3] = 0.0
    assert tinc.preds_to_score(p) == jinc.preds_to_score(p)
    seeds = []

    def sample_fn(s, b):
        seeds.append(tuple(s.tolist()))
        return torch.arange(b) % 10

    uniform = tinc.InceptionScore(sample_fn, lambda x: torch.zeros(len(x), 10), batch=100,
                                  device="cpu")((), n=1000)
    assert uniform[0] == pytest.approx(1.0) and len(set(seeds)) == 10
    assert seeds == [tuple(tinc.batch_seeds(0, i).tolist()) for i in range(10)]
    sharp = tinc.InceptionScore(sample_fn, lambda x: 50.0 * torch.eye(10)[x], batch=100,
                                device="cpu")((), n=1000)
    assert sharp[0] == pytest.approx(10.0, rel=1e-6)


def test_recovery_report_matches_jax():
    rs = np.random.RandomState(1)
    true_c = np.full((10, 10), 0.4 / 9)
    np.fill_diagonal(true_c, 0.6)
    learned = true_c[rs.permutation(10)] + rs.uniform(0, 0.02, (10, 10))
    learned /= learned.sum(1, keepdims=True)
    got, want = trec.recovery_report(learned, true_c), jrec.recovery_report(learned, true_c)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_cifar_flags_have_jax_names_and_defaults():
    """Every CIFAR flag of the JAX package with its default, the
    ``--no<flag>`` negation, and parsed values of each type."""
    want = vars(jconfig.parse(jconfig.cifar_flags(), []))
    got = vars(tconfig.parse(tconfig.cifar_flags(), []))
    assert got == want
    argv = ["--nodecay", "--perm_classifier", "--alpha", "0.6", "--niters", "7", "--run", "x",
            "--opt_moment_dtype", "bfloat16"]
    assert vars(tconfig.parse(tconfig.cifar_flags(), argv)) == \
        vars(jconfig.parse(jconfig.cifar_flags(), argv))
    with pytest.raises(SystemExit):
        tconfig.parse(tconfig.cifar_flags(), ["--bogus_flag"])
