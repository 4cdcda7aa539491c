"""MNIST gen-label-acc, the JAX app against the port's, at the archived
rcgan recipe's flags (``scripts/torch_mnist_recipe.sh``) cut in width and
epochs: ``gf_dim``/``df_dim`` 16 and ``gfc_dim``/``dfc_dim`` 256 (the recipe
runs 64 and 1024), 5 epochs of 6 000 synthetic digits at batch 100, float32,
so that the gen-label-acc of epoch 4 lands; each side's last samples are
scored by both sides' pinned eval classifiers.  It settles whether the gap
between the recipes' gen-label-acc (port 0.99, JAX 0.80) comes from the
classifiers or from the training.

Run on the CPU, where both packages import, from the repository's root
(about 2 minutes a run on 4 threads; each side's classifier is trained once
and pinned under ``ROOT/<side>``)::

    JAX_PLATFORMS=cpu python tests/test_torch_mnist_gen_label_acc.py run port 547 ROOT
    JAX_PLATFORMS=cpu python tests/test_torch_mnist_gen_label_acc.py run jax 547 ROOT
    ...  (seeds 547, 548, 549 a side)
    JAX_PLATFORMS=cpu python tests/test_torch_mnist_gen_label_acc.py score jax ROOT
    JAX_PLATFORMS=cpu python tests/test_torch_mnist_gen_label_acc.py score port ROOT

``run`` writes ``ROOT/<side>_<seed>.npz`` (the app's last gen-label-acc
samples, their labels and its accuracy); ``score`` prints and writes, for
every such file, the accuracy under that side's classifier beside the one
the run's own classifier gave.  The test below holds the cut to the
recipe's flags.
"""

import functools
import glob
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(gf_dim=16, df_dim=16, gfc_dim=256, dfc_dim=256)
CUT = ["--epoch", "5", "--train_size", "6000", "--eval_train_size", "10000", "--recover_epoch",
       "5", "--compute_dtype", "float32"]


def recipe_flags():
    """The MNIST app's flags in ``scripts/torch_mnist_recipe.sh``, without
    the ones that name its work dirs and its epochs."""
    text = open(os.path.join(REPO, "scripts", "torch_mnist_recipe.sh")).read()
    args = re.search(r"' (--algorithm .*?) 2>&1", text, re.S).group(1).replace("\\\n", " ")
    out, skip = [], False
    for a in args.split():
        if skip:
            skip = False
        elif a in ("--epoch", "--checkpoint_dir", "--data_dir", "--logs_dir"):
            skip = True
        else:
            out.append(a)
    return out


def flags(seed: int, root: str, side: str):
    keep = [a for a in recipe_flags() if a not in ("--compute_dtype", "bfloat16")]
    return keep + CUT + ["--seed", str(seed), "--checkpoint_dir", f"{root}/{side}", "--data_dir",
                         f"{root}/data_none", "--logs_dir", f"{root}/{side}/logs"]


def run(side: str, seed: int, root: str) -> None:
    got = {}
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rcgan_tpu.apps import mnist_app as app
        from rcgan_tpu.models.dcgan import DCGANConfig
        kw = {}
    else:
        import torch

        torch.set_num_threads(4)
        from rcgan_tpu_torch.apps import mnist_app as app
        from rcgan_tpu_torch.models.dcgan import DCGANConfig
        kw = {"device": "cpu"}
    app.DCGANConfig = functools.partial(DCGANConfig, **WIDTH)
    scored = app.generated_label_accuracy

    def record(cls, samples, labels, *a, **k):
        acc = scored(cls, samples, labels, *a, **k)
        s = samples.detach().cpu().numpy() if hasattr(samples, "detach") else np.asarray(samples)
        got.update(samples=s, labels=np.asarray(labels), acc=acc)
        return acc

    app.generated_label_accuracy = record
    app.main(flags(seed, root, side), **kw)
    np.savez(f"{root}/{side}_{seed}.npz", **got)
    print(side, seed, "gen_label_acc", got["acc"], flush=True)


def score(side: str, root: str) -> None:
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rcgan_tpu.evals.classifier import generated_label_accuracy, mnist_classifier
        cls, conv = mnist_classifier(), np.asarray
    else:
        import torch

        from rcgan_tpu_torch.evals.classifier import generated_label_accuracy, mnist_classifier
        cls, conv = mnist_classifier(device="cpu"), torch.from_numpy
    if not cls.load(f"{root}/{side}/mnist_eval_classifier.pkl"):
        raise FileNotFoundError(f"no pinned classifier under {root}/{side}: run that side first")
    out = {}
    for f in sorted(glob.glob(f"{root}/*_*.npz")):
        z = np.load(f)
        out[os.path.basename(f)] = {
            f"{side}'s classifier": float(generated_label_accuracy(cls, conv(z["samples"]),
                                                                   z["labels"])),
            "its own run's": float(z["acc"])}
    json.dump(out, open(f"{root}/score_{side}_classifier.json", "w"), indent=1)
    print(json.dumps(out, indent=1))


def test_the_cut_keeps_the_recipes_flags():
    """Every flag of the recipe's app command is in the cut run with its
    value, but the compute dtype (float32 on the CPU) and the cuts."""
    import sys as _sys

    _sys.path.insert(0, REPO)
    from rcgan_tpu_torch import config

    got = config.parse(config.mnist_flags(), flags(547, "/r", "port"))
    want = config.parse(config.mnist_flags(), recipe_flags())
    cut = {"epoch", "train_size", "eval_train_size", "recover_epoch", "compute_dtype", "seed",
           "checkpoint_dir", "data_dir", "logs_dir"}
    assert {k: v for k, v in vars(got).items() if k not in cut} == \
        {k: v for k, v in vars(want).items() if k not in cut}
    assert (got.algorithm, got.alpha, got.disc_type, got.batch_size, got.epoch) == \
        ("rcgan", 0.3, "projection", 100, 5)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "run":
        run(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        score(sys.argv[2], sys.argv[3])
