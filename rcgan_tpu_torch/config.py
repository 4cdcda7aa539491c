"""CLI flags with TF1 ``tf.app.flags`` semantics, the counterpart of
``rcgan_tpu/config.py`` (``FlagParser``, ``mnist_flags``, ``cifar_flags``,
``parse``): the same flag names and defaults, the ``--flag`` / ``--noflag``
boolean negation the reference's run scripts use, and ``--aux_classifier``
as the run scripts' alias of ``--perm_regularizer``."""

from __future__ import annotations

import argparse
from typing import Sequence


class FlagParser(argparse.ArgumentParser):
    def define_string(self, name, default, help=""):
        self.add_argument(f"--{name}", type=str, default=default, help=help)

    def define_integer(self, name, default, help=""):
        self.add_argument(f"--{name}", type=int, default=default, help=help)

    def define_float(self, name, default, help=""):
        self.add_argument(f"--{name}", type=float, default=default, help=help)

    def define_boolean(self, name, default, help=""):
        group = self.add_mutually_exclusive_group()
        group.add_argument(f"--{name}", dest=name, action="store_true", help=help)
        group.add_argument(f"--no{name}", dest=name, action="store_false")
        self.set_defaults(**{name: default})

    def define_list(self, name, default, help=""):
        self.add_argument(f"--{name}", type=lambda s: s.split(","), default=list(default),
                          help=help)


def mnist_flags() -> FlagParser:
    """The 34 MNIST flags (``mnist/main.py:12-66``) and the JAX package's
    extensions: the same names and defaults."""
    p = FlagParser(description="rcgan_tpu_torch MNIST trainer")
    # the reference's default is 5 (its help text says 25); the run scripts
    # always pass --epoch
    p.define_integer("epoch", 5, "Epochs to train [25]")
    p.define_float("learning_rate", 0.0002, "Adam learning rate")
    p.define_float("beta1", 0.5, "Adam beta1")
    p.define_float("train_size", float("inf"), "Max train images")
    p.define_integer("batch_size", 100, "Batch size")
    p.define_integer("input_height", 108, "Input height (forced to 28)")
    p.define_integer("input_width", None, "Input width")
    p.define_integer("output_height", 64, "Output height (forced to 28)")
    p.define_integer("output_width", None, "Output width")
    p.define_string("dataset", "mnist", "Dataset name")
    p.define_string("checkpoint_dir", "rcgan", "Checkpoint root")
    p.define_string("checkpoint", None, "Existing checkpoint dir name")
    p.define_string("sample_dir", "samples/", "Sample output dir")
    p.define_string("data_dir", "../data/", "Dataset root")
    p.define_string("dir_prefix", None, "Run dir name prefix")
    p.define_string("logs_dir", "./logs", "Logs dir")
    p.define_boolean("logs_at_ckpt", False, "Put logs in checkpoint dir")
    p.define_string("script_file", None, "Script file to archive")
    p.define_boolean("train", False, "Train (else load + recover)")
    p.define_boolean("crop", False, "Center-crop input")
    p.define_boolean("visualize", False, "Run z-space visualizations")
    p.define_integer("z_dim", 100, "Generator noise dim")
    p.define_string("algorithm", "biased", "[biased, unbiased, rcgan, ambient]")
    p.define_boolean("estimate_confuse", True, "Learn the confusion matrix (RCGAN-U)")
    p.define_float("confuse_multiplier", 10.0, "LR multiplier for confusion matrix")
    # an extension: the CIFAR stack's --confuse_init on the MNIST stack
    p.define_boolean("confuse_init", False, "Diagonal-dominant C-logits init")
    p.define_float("confuse_init_diag", 0.2, "Initial C diagonal")
    p.define_boolean("perm_regularizer", True, "Use permutation-regularizer classifier")
    # the run scripts toggle this as --aux_classifier/--noaux_classifier
    p.define_boolean("aux_classifier", None, "Alias of perm_regularizer")
    p.define_float("perm_multiplier", 10.0, "Weight of the perm-classifier G loss")
    p.define_float("alpha", 1.0, "Label noise level (P(label survives))")
    p.define_boolean("confusion_class_depend", False, "Class-dependent confusion rows")
    p.define_string("disc_type", "vanilla", "[vanilla, projection]")
    p.define_string("loss_fn", "hinge", "GAN loss [hinge, ce]")
    p.define_boolean("real_match", False, "y_gen := y_real per batch")
    p.define_boolean("add_noise", False, "RCGAN+y annealed label re-noising")
    p.define_float("noise_alpha", 0.3, "Effective starting noise level")
    p.define_integer("noise_start", 30, "Noise schedule start epoch")
    p.define_integer("noise_end", 80, "Noise schedule end epoch")
    p.define_boolean("concat_y", False, "Concat one-hot y into projection D")
    p.define_list("concat_y_layers", ["1"], "Layers (1-4) for concat_y")
    p.define_boolean("spectral_norm", True, "Spectral norm on D convs")
    p.define_boolean("max_norm", True, "Unit-clip constraint on D linears")
    p.define_integer("recover_epoch", 1000, "Label-recovery GD steps")
    p.define_integer("recover_batch_size", 500, "Label-recovery batch")
    p.define_float("recover_learning_rate", 5.0e2, "Label-recovery lr")
    # extensions of the JAX package
    p.define_string("compute_dtype", "bfloat16", "bfloat16|float32 compute")
    p.define_boolean("allow_synthetic", True, "Use synthetic data when files missing")
    p.define_integer("seed", 547, "Data shuffle seed")
    p.define_integer("mesh_devices", 1, "Data-parallel size (1 = single device; 0 = all)")
    p.define_integer("eval_train_size", 60000, "Eval-classifier training examples")
    p.define_boolean("device_data", True,
                     "Keep the dataset resident on the device and run 50-iteration blocks")
    return p


def cifar_flags() -> FlagParser:
    """The CIFAR flags (``cifar10/gan_resnet.py:40-76``), the module
    constants exposed as flags, and the JAX package's extensions: the same
    names and defaults."""
    p = FlagParser(description="rcgan_tpu_torch CIFAR-10 ResNet GAN trainer")
    p.define_string("dataset", "cifar", "Dataset")
    # replication offset for init, label noise and the training draws; 0 is
    # the archived stream; the synthetic class universe stays fixed, so
    # pinned eval classifiers stay valid across seeds
    p.define_integer("seed", 0, "Replication seed offset (0 = archived stream)")
    p.define_string("algorithm", "rcgan", "[rcgan, rcgan-u, biased, unbiased]")
    p.define_float("alpha", 0.8, "1 - noise level")
    p.define_string("run", "0", "Run name")
    p.define_string("log_file", None, "Logging file")
    p.define_string("parent_dir", ".", "Parent dir for checkpoints")
    p.define_string("expt_dir", None, "Experiment dir override")
    p.define_integer("inception_freq", 2500, "Inception score cadence")
    p.define_integer("sample_freq", 2500, "Dev-cost + samples cadence")
    p.define_integer("generated_label_accuracy_freq", 2500, "Gen-label-acc cadence")
    p.define_integer("sample_save_freq", 0, "Sample dump cadence")
    p.define_integer("batch_size", 64, "Critic batch size")
    p.define_integer("niters", 50000, "Iterations")
    p.define_float("lr", 2.0e-4, "Learning rate")
    p.define_integer("ngpus", 2, "Device count — sets the data-parallel size "
                     "(capped at available devices; --mesh_devices overrides)")
    p.define_boolean("multi_gpu_multi_batch", True,
                     "Scale global batch by device count, divide iters")
    p.define_boolean("confuse_init", False, "Diagonal-dominant C-logits init")
    p.define_float("confuse_init_diag", 0.2, "Initial C diagonal")
    p.define_float("confuse_multiplier", 1.0, "LR multiplier for learned C")
    p.define_boolean("confuse_lr_decay", False, "Decay learned-C lr")
    p.define_boolean("perm_classifier", False, "Permutation-regularizer classifier")
    p.define_float("perm_multiplier", 1.0, "Perm classifier G-loss weight")
    p.define_string("perm_type", "linear", "[linear, 2layer]")
    p.define_boolean("restore", True, "Auto-resume from latest checkpoint")
    p.define_boolean("perm_gen_label_acc", False,
                     "Permutation-corrected final gen-label accuracy")
    p.define_string("log_level", "info", "[info, debug]")
    # module constants exposed as flags (gan_resnet.py:140-192)
    p.define_string("data_dir", "../data/cifar10/cifar-10-batches-py/", "CIFAR path")
    p.define_integer("gen_bs_multiple", 2, "Generator batch multiple")
    p.define_integer("z_dim", 128, "Noise dim")
    p.define_integer("dim_g", 128, "Generator width")
    p.define_integer("dim_d", 128, "Critic width")
    p.define_integer("n_critic", 5, "Critic steps per G step")
    p.define_string("loss_type", "HINGE", "[HINGE, Goodfellow, WGAN]")
    p.define_boolean("soft_plus", False, "Softplus loss variants")
    p.define_boolean("decay", True, "Linear LR decay")
    p.define_integer("embedding_dim", 300, "Label embedding dim")
    # extensions of the JAX package
    p.define_string("compute_dtype", "bfloat16", "bfloat16|float32 compute")
    p.define_boolean("allow_synthetic", True, "Use synthetic data when files missing")
    p.define_integer("mesh_devices", 0,
                     "Data-parallel size override (0 = follow --ngpus, capped at "
                     "available devices)")
    p.define_integer("eval_train_size", 20000, "Eval-classifier training examples")
    p.define_integer("synthetic_train_size", 50000, "Synthetic dataset size")
    p.define_integer("profile_steps", 0, "Capture a torch.profiler trace of N warm steps")
    p.define_string("opt_moment_dtype", None,
                    "Adam moment storage dtype override (e.g. bfloat16; default float32)")
    p.define_boolean("device_data", True,
                     "Keep the full dataset resident on the device and feed index "
                     "batches (no per-iteration host transfers)")
    p.define_integer("scan_block", 100,
                     "Run up to N train cycles per block (device_data path; blocks end "
                     "exactly on every cadence iteration; metric flushes below iter 500 "
                     "coalesce to block ends). 0/1 = off")
    p.define_integer("ckpt_early_every", 25,
                     "Checkpoint cadence within the first 500 iters (the reference saves "
                     "every early iteration; set 1 for its exact cadence)")
    return p


def parse(parser: FlagParser, argv: Sequence[str] | None = None):
    flags = parser.parse_args(argv)
    if getattr(flags, "aux_classifier", None) is not None:
        flags.perm_regularizer = flags.aux_classifier
    return flags
