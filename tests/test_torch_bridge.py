"""Weight bridge between the JAX package and the port, on the CPU.

Layouts and names are shared, so every check here is exact (bit-equal),
except where a test says otherwise.
"""

import numpy as np
import pytest

import jax
import torch

from rcgan_tpu.algorithms.cifar import CifarAlgoConfig
from rcgan_tpu.core.module import count_params as jax_count_params
from rcgan_tpu.data.confusion import one_coin_matrix
from rcgan_tpu.models.resnet_gan import ResnetGANConfig as JaxConfig
from rcgan_tpu.train.cifar_loop import CifarTrainConfig, CifarTrainer
from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig as TorchAlgoConfig
from rcgan_tpu_torch.bridge import (gan_from_jax, generator_from_jax, load_npz, load_tree,
                                    save_npz, to_jax_tree)
from rcgan_tpu_torch.core.module import count_params, param_tree, state_tree
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig

torch.set_num_threads(min(2, torch.get_num_threads()))

_KW = dict(dim_g=8, dim_d=8, embedding_dim=12, algorithm="rcgan-u")
_ALGO = dict(algorithm="rcgan-u", perm_classifier=True)


@pytest.fixture(scope="module")
def jax_params():
    """A trainer's full tree (G, D with the perm classifier, and the
    confusion logits) and its state (every SN u), affine tables and biases
    perturbed so no value is a constant."""
    tr = CifarTrainer(JaxConfig(**_KW), CifarAlgoConfig(**_ALGO), CifarTrainConfig(),
                      one_coin_matrix(0.6, 10))
    ts = tr.init(jax.random.key(0), 4)
    params = jax.tree_util.tree_map(np.asarray, ts.params)
    rs = np.random.RandomState(0)
    for layer, d in params.items():
        for var, a in d.items():
            if var in ("scale", "offset", "Biases", "b"):
                d[var] = (a + 0.3 * rs.randn(*a.shape)).astype(a.dtype)
    return params, jax.tree_util.tree_map(np.asarray, ts.state)


def _g_only(tree):
    return {k: v for k, v in tree.items() if k.startswith("G.")}


def test_round_trip_is_bit_exact(jax_params):
    params, state = jax_params
    gen = generator_from_jax(params, ResnetGANConfig(**_KW), device="cpu", state=state)
    back, back_state = to_jax_tree(gen)
    g = _g_only(params)
    assert sorted(back) == sorted(g)
    for layer, d in g.items():
        assert sorted(back[layer]) == sorted(d)
        for var, a in d.items():
            assert back[layer][var].dtype == a.dtype
            np.testing.assert_array_equal(back[layer][var], a)
    assert count_params(back) == jax_count_params(g)
    assert state_tree(gen) == {} == back_state  # cond-BN keeps no running stats; G has no SN


def test_npz_round_trip(jax_params, tmp_path):
    params, _ = jax_params
    path = str(tmp_path / "generator.npz")
    save_npz(path, _g_only(params))
    loaded = load_npz(path)
    gen = generator_from_jax(loaded, ResnetGANConfig(**_KW), device="cpu")
    save_npz(str(tmp_path / "again.npz"), to_jax_tree(gen)[0])
    again = load_npz(str(tmp_path / "again.npz"))
    for layer, d in _g_only(params).items():
        for var, a in d.items():
            np.testing.assert_array_equal(loaded[layer][var], a)
            np.testing.assert_array_equal(again[layer][var], a)


def test_port_generator_has_the_jax_names_and_shapes(jax_params):
    params, _ = jax_params
    mine = param_tree(Generator(ResnetGANConfig(**_KW), device="cpu"))
    theirs = _g_only(params)
    assert {k: {v: tuple(t.shape) for v, t in d.items()} for k, d in mine.items()} == \
        {k: {v: a.shape for v, a in d.items()} for k, d in theirs.items()}


def test_load_tree_rejects_mismatches(jax_params):
    params, _ = jax_params
    cfg = ResnetGANConfig(**_KW)
    missing = {k: v for k, v in params.items() if k != "G.Block.2.Conv1"}
    with pytest.raises(KeyError, match="G.Block.2.Conv1"):
        generator_from_jax(missing, cfg, device="cpu")
    extra = dict(params, **{"G.Extra": {"W": np.zeros((2, 2), np.float32)}})
    with pytest.raises(KeyError, match="G.Extra"):
        generator_from_jax(extra, cfg, device="cpu")
    wrong = {k: dict(v) for k, v in params.items()}
    wrong["G.Output"]["Filters"] = np.zeros((3, 3, 16, 4), np.float32)
    with pytest.raises(ValueError, match="G.Output/Filters"):
        generator_from_jax(wrong, cfg, device="cpu")
    with pytest.raises(KeyError, match="state layers differ"):
        generator_from_jax(params, cfg, device="cpu", state={"G.Input": {"u": np.zeros((1, 4))}})
    with pytest.raises(ValueError, match="shape"):
        load_tree(Generator(ResnetGANConfig(dim_g=16, dim_d=8, embedding_dim=12), device="cpu"),
                  params)


def test_trainer_tree_round_trip_is_bit_exact(jax_params):
    """Every G.*, D.* and confusion_logits parameter and every SN u of a
    trainer's tree, through gan_from_jax and back."""
    params, state = jax_params
    gan = gan_from_jax(params, state, ResnetGANConfig(**_KW), TorchAlgoConfig(**_ALGO), "cpu")
    back, back_state = to_jax_tree(gan)
    assert "confusion_logits" in back and "D.d_perm_classifier_h1" in back_state
    assert len(back_state) == 17 and all(set(d) == {"u"} for d in back_state.values())
    for tree, mine in ((params, back), (state, back_state)):
        assert sorted(mine) == sorted(tree)
        for layer, d in tree.items():
            assert sorted(mine[layer]) == sorted(d)
            for var, a in d.items():
                assert mine[layer][var].dtype == a.dtype
                np.testing.assert_array_equal(mine[layer][var], a)
    assert count_params(back) == jax_count_params(params)


def test_load_tree_rejects_a_missing_or_misshapen_u(jax_params):
    params, state = jax_params
    cfg, acfg = ResnetGANConfig(**_KW), TorchAlgoConfig(**_ALGO)
    missing = {k: v for k, v in state.items() if k != "D.Block.3.Conv1"}
    with pytest.raises(KeyError, match="state layers differ.*D.Block.3.Conv1"):
        gan_from_jax(params, missing, cfg, acfg, "cpu")
    renamed = dict(state, **{"D.Output": {"v": state["D.Output"]["u"]}})
    with pytest.raises(KeyError, match="state vars of D.Output"):
        gan_from_jax(params, renamed, cfg, acfg, "cpu")
    wrong = dict(state, **{"D.Output": {"u": np.zeros((1, 2), np.float32)}})
    with pytest.raises(ValueError, match="D.Output/u"):
        gan_from_jax(params, wrong, cfg, acfg, "cpu")
    with pytest.raises(KeyError, match="state layers differ"):
        gan_from_jax(params, None, cfg, acfg, "cpu")
