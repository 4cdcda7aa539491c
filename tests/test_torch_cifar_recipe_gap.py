"""CIFAR stand-in Inception score and dev cost, the JAX app against the
port's, at the archived rcgan recipe's flags
(``scripts/torch_cifar_recipe.sh``) cut: ``dim_g``/``dim_d`` 16 and
``embedding_dim`` 24 (the recipe runs 128, 128 and 300), 1 500 iterations
on the synthetic split with the Inception score, the dev cost and
gen-label-acc every 750 (the recipe's cut runs 5 000 with them every 2 500),
float32.  Each side's last Inception samples (the 50 000 the app scored at
1 499) are scored by both sides' pinned stand-in scorers.  It asks whether
the gap between the recipes' readings at 4 999 (stand-in Inception 7.06
against 7.76, dev cost 0.60 against 0.91) comes from the scorers, from the
seed or from the training.

On the JAX side the app's scanned programs run as Python loops of jitted
straight-line programs with the same keys (:func:`_unrolled_jax`): XLA's
CPU backend runs the cycle's convolutions inside a ``lax.scan`` or
``lax.cond`` about 20 times slower than in straight-line code (60 s
against 3 s a cycle at this width on one core), which would put 1 500
iterations at a day.

Run on the CPU, where both packages import, from the repository's root
(about 1 h a run on one core; each side's eval classifier is trained once
and pinned under ``ROOT/<side>``: run one seed a side first, or copy a
pinned ``cifar_eval_classifier.pkl`` there)::

    JAX_PLATFORMS=cpu python tests/test_torch_cifar_recipe_gap.py run port 547 ROOT
    JAX_PLATFORMS=cpu python tests/test_torch_cifar_recipe_gap.py run jax 547 ROOT
    ...  (seeds 547, 548, 549 a side)
    JAX_PLATFORMS=cpu python tests/test_torch_cifar_recipe_gap.py score jax ROOT
    JAX_PLATFORMS=cpu python tests/test_torch_cifar_recipe_gap.py score port ROOT

``run`` writes ``ROOT/<side>_<seed>.npz`` (the last Inception samples as
float16 ``[50000, 32, 32, 3]``, and every reading of the stand-in score,
the dev cost and gen-label-acc with its iteration); ``score`` prints and
writes, for every such file, the score of those samples under that side's
scorer beside the run's own readings.  The test below holds the cut to the
recipe's flags.
"""

import glob
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVERY = 750  # the Inception score, the dev cost and gen-label-acc
CUT = ["--dim_g", "16", "--dim_d", "16", "--embedding_dim", "24", "--niters", str(2 * EVERY),
       "--inception_freq", str(EVERY), "--sample_freq", str(EVERY),
       "--generated_label_accuracy_freq", str(EVERY), "--compute_dtype", "float32"]
READINGS = ("inception_50k", "dev_cost", "gen_label_acc")
N_SCORED, SCORE_BATCH = 50000, 500  # the app's Inception score


def recipe_flags():
    """The CIFAR app's flags in ``scripts/torch_cifar_recipe.sh``, without
    the ones that name its work dirs and its iterations."""
    text = open(os.path.join(REPO, "scripts", "torch_cifar_recipe.sh")).read()
    args = re.search(r"cifar_app (--algorithm .*?)\n(?!\s*--)", text, re.S).group(1)
    out, skip = [], False
    for a in args.replace("\\\n", " ").split():
        if skip:
            skip = False
        elif a in ("--parent_dir", "--expt_dir", "--log_file", "--data_dir", "--niters"):
            skip = True
        else:
            out.append(a)
    return out


def flags(seed: int, root: str, side: str):
    keep = [a for a in recipe_flags() if a not in ("--compute_dtype", "bfloat16")]
    return keep + CUT + ["--seed", str(seed), "--parent_dir", f"{root}/{side}", "--expt_dir",
                         f"{side}_{seed}", "--log_file", f"{root}/{side}_{seed}.log",
                         "--data_dir", f"{root}/data_none"]


def _unrolled_jax(app, batches):
    """The JAX app's scanned programs as Python loops of jitted straight-line
    programs, each with the keys and the arithmetic of its scan: a block of
    cycles (``step_scan``: cycle ``j`` keyed ``fold_in(key, ts.step)``, the
    cycle at iteration > 0 with ``static_unroll=True``, which
    ``tests/test_train.py`` holds to the rolled cycle, iteration 0 rolled),
    the dev cost's scan (batch ``k`` keyed ``split(key, K)[k]``) and the
    Inception score (batch ``i`` keyed ``fold_in(key(0), i)``, its samples
    kept in ``batches``)."""
    import jax
    import jax.numpy as jnp
    from rcgan_tpu.evals.inception import preds_to_score

    trainer_cls = app.CifarTrainer

    def step_scan(self, ts, idx, g_random, g_biased, rng):
        if not hasattr(self, "_unrolled_cycle"):
            self._unrolled_cycle = jax.jit(lambda ts, db, gl, it, key, ds: self._cycle(
                ts, db, gl, it, key, None, ds, static_unroll=True), donate_argnums=0)
        ms = []
        for j in range(len(idx)):
            step = int(ts.step)
            fn = self._unrolled_cycle if step > 0 else self._jitted_cycle
            ts, m = fn(ts, {"index": jnp.asarray(idx[j], jnp.int32)},
                       {"random": jnp.asarray(g_random[j], jnp.int32),
                        "biased": jnp.asarray(g_biased[j], jnp.int32)},
                       jnp.asarray(step, jnp.int32), jax.random.fold_in(rng, step),
                       self.device_dataset)
            ms.append(m)
        return ts, jax.tree_util.tree_map(lambda *v: jnp.stack(v), *ms)

    def eval_disc_cost_scan(self, ts, dataset, idx, rng):
        if not hasattr(self, "_dev_cost"):
            self._dev_cost = jax.jit(lambda ts, batch, key: self.eval_disc_cost(ts, batch, key))
        keys = jax.random.split(rng, len(idx))
        return jnp.mean(jnp.stack([self._dev_cost(ts, {k: jnp.take(v, jnp.asarray(row, jnp.int32),
                                                                    axis=0)
                                                       for k, v in dataset.items()}, keys[i])
                                   for i, row in enumerate(idx)]))

    def inception_score(sample_fn, logits_fn, n=N_SCORED, batch=SCORE_BATCH, splits=10):
        probs = jax.jit(lambda x: jax.nn.softmax(logits_fn(x), axis=-1))
        key = jax.random.key(0)
        batches[:] = [np.asarray(sample_fn(jax.random.fold_in(key, i), batch))
                      for i in range(n // batch)]
        preds = [np.asarray(probs(x)) for x in batches]
        batches[:] = [x.astype(np.float16) for x in batches]
        return preds_to_score(np.concatenate(preds), splits)

    trainer_cls.step_scan = step_scan
    trainer_cls.eval_disc_cost_scan = eval_disc_cost_scan
    app.inception_score = inception_score


def run(side: str, seed: int, root: str) -> None:
    got = {k: [] for k in READINGS}
    batches = []
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rcgan_tpu.apps import cifar_app as app
        _unrolled_jax(app, batches)
        kw = {}
    else:
        import torch

        torch.set_num_threads(int(os.environ.get("GAP_THREADS", "2")))
        from rcgan_tpu_torch.apps import cifar_app as app
        scorers = app._scorers

        def recording_scorers(*a, **k):
            eval_cls, logits_fn = scorers(*a, **k)

            def logits(x):
                batches.append(x.detach().cpu().numpy().astype(np.float16))
                del batches[:-(N_SCORED // SCORE_BATCH)]  # the last score's
                return logits_fn(x)

            return eval_cls, logits

        app._scorers = recording_scorers
        kw = {"device": "cpu"}

    class Recorded(app.MetricLogger):
        def plot_at(self, name, value, step):
            if name in got:
                got[name].append((int(step), float(value)))
            super().plot_at(name, value, step)

    app.MetricLogger = Recorded
    os.makedirs(f"{root}/{side}", exist_ok=True)
    app.main(flags(seed, root, side), **kw)
    np.savez(f"{root}/{side}_{seed}.npz", samples=np.concatenate(batches),
             **{k: np.array(v, np.float64).reshape(-1, 2) for k, v in got.items()})
    print(side, seed, json.dumps(got), flush=True)


def score(side: str, root: str) -> None:
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rcgan_tpu.evals.classifier import cifar_classifier
        from rcgan_tpu.evals.inception import preds_to_score
        cls = cifar_classifier()
        logits = jax.jit(lambda x: jax.nn.softmax(cls.logits(cls.params, x), axis=-1))
        probs = lambda x: np.asarray(logits(x))
    else:
        import torch

        from rcgan_tpu_torch.evals.classifier import cifar_classifier
        from rcgan_tpu_torch.evals.inception import preds_to_score
        cls = cifar_classifier(device="cpu")
        probs = lambda x: torch.softmax(cls.logits(torch.from_numpy(x)), -1).numpy()
    if not cls.load(f"{root}/{side}/cifar_eval_classifier.pkl"):
        raise FileNotFoundError(f"no pinned classifier under {root}/{side}: run that side first")
    out = {}
    for f in sorted(glob.glob(f"{root}/*_*.npz")):
        z = np.load(f)
        x = z["samples"]
        p = np.concatenate([probs(x[i:i + SCORE_BATCH].astype(np.float32))
                            for i in range(0, len(x), SCORE_BATCH)])
        out[os.path.basename(f)] = {
            f"{side}'s scorer": preds_to_score(p, 10)[0],
            **{f"its own run's {k}": z[k].tolist() for k in READINGS}}
    json.dump(out, open(f"{root}/score_{side}_scorer.json", "w"), indent=1)
    print(json.dumps(out, indent=1))


def test_the_cut_keeps_the_recipes_flags():
    """Every flag of the recipe's app command is in the cut run with its
    value, but the compute dtype (float32 on the CPU), the widths, the work
    dirs and the seed; both evals land twice."""
    sys.path.insert(0, REPO)
    from rcgan_tpu_torch import config

    got = config.parse(config.cifar_flags(), flags(547, "/r", "port"))
    want = config.parse(config.cifar_flags(), recipe_flags() + ["--niters", "5000"])
    cut = {"dim_g", "dim_d", "embedding_dim", "compute_dtype", "seed", "parent_dir", "expt_dir",
           "log_file", "data_dir", "niters", "inception_freq", "sample_freq",
           "generated_label_accuracy_freq"}
    assert {k: v for k, v in vars(got).items() if k not in cut} == \
        {k: v for k, v in vars(want).items() if k not in cut}
    assert (got.algorithm, got.alpha, got.batch_size, got.n_critic, got.mesh_devices) == \
        ("rcgan", 0.6, 64, 5, 1)
    assert (got.dim_g, got.dim_d, got.embedding_dim, got.compute_dtype) == \
        (16, 16, 24, "float32")
    # the recipe's cut lands every eval twice, at its middle and its end; so does this one
    for cfg in (want, got):
        for freq in (cfg.inception_freq, cfg.sample_freq, cfg.generated_label_accuracy_freq):
            assert [i for i in range(cfg.niters) if i % freq == freq - 1] == \
                [cfg.niters // 2 - 1, cfg.niters - 1]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "run":
        run(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        score(sys.argv[2], sys.argv[3])
