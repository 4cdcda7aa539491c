"""The port's ImageNet data helpers (``rcgan_tpu_torch/data/imagenet.py``)
against the JAX package's ``rcgan_tpu/data/imagenet.py`` on the CPU: the
small-ImageNet shard generator, the resize and center crop, and the
image-folder pipeline, bit for bit; and the module imports where PIL is
absent (PIL is imported inside the functions, as the GPU machine may lack
it)."""

import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from rcgan_tpu.data import imagenet as jim
from rcgan_tpu_torch.data import imagenet as tim


def test_small_imagenet_generator_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    for i in (1, 2, 4):  # shard 3 missing: skipped, as in JAX
        np.save(tmp_path / f"train_data_batch_{i}.npy",
                rs.randint(0, 256, (23, 3 * 8 * 8)).astype(np.uint8))
    for seed in (0, 5):
        mine = list(tim.small_imagenet_generator(str(tmp_path), 4, n_files=4, seed=seed)())
        theirs = list(jim.small_imagenet_generator(str(tmp_path), 4, n_files=4, seed=seed)())
        assert len(mine) == len(theirs) == 3 * (23 // 4)
        for a, b in zip(mine, theirs):
            assert a.dtype == np.uint8 and a.shape == (4, 192)
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="no small-imagenet shards"):
        tim.small_imagenet_generator(str(tmp_path / "none"), 4)


@pytest.mark.parametrize("shape,size", [((40, 60, 3), 16), ((33, 21, 3), 20), ((8, 8, 3), 8)])
def test_center_crop_resize_matches_jax(shape, size):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    got = tim.center_crop_resize(img, size)
    assert got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jim.center_crop_resize(img, size))


def test_image_folder_generator_matches_jax(tmp_path):
    """Class subdirs in sorted order, the extension filter (case-blind), the
    seeded order, RGB conversion of a grey image, and the per-image crop."""
    rs = np.random.RandomState(1)
    for cls, n in (("zebra", 3), ("ant", 4), ("cat", 2)):
        (tmp_path / cls).mkdir()
        for k in range(n):
            shape = (20 + k, 30, 3) if k % 2 == 0 else (25, 18)
            Image.fromarray(rs.randint(0, 256, shape).astype(np.uint8)).save(
                tmp_path / cls / f"{k}.{'PNG' if k == 1 else 'png'}")
        (tmp_path / cls / "notes.txt").write_text("skipped")
    get, classes = tim.image_folder_generator(str(tmp_path), 2, size=12, seed=3)
    jget, jclasses = jim.image_folder_generator(str(tmp_path), 2, size=12, seed=3)
    assert classes == jclasses == ["ant", "cat", "zebra"]
    mine, theirs = list(get()), list(jget())
    assert len(mine) == len(theirs) == 9 // 2
    for (im, lab), (jmg, jlab) in zip(mine, theirs):
        assert im.shape == (2, 12, 12, 3) and im.dtype == np.uint8 and lab.dtype == np.int32
        np.testing.assert_array_equal(im, jmg)
        np.testing.assert_array_equal(lab, jlab)
    with pytest.raises(FileNotFoundError, match="no images"):
        tim.image_folder_generator(str(tmp_path / "zebra"), 2, class_from_subdir=False,
                                   extensions=(".jpg",))


def test_module_imports_without_pil():
    """With PIL blocked the module imports and the shard generator works;
    only the functions that decode or resize need PIL."""
    code = ("import sys; sys.modules['PIL'] = None\n"
            "import numpy as np\n"
            "from rcgan_tpu_torch.data import imagenet\n"
            "try:\n"
            "    imagenet.center_crop_resize(np.zeros((4, 4, 3), np.uint8), 2)\n"
            "except ImportError:\n"
            "    print('no PIL')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no PIL"


def test_no_module_of_the_port_imports_pil_at_import_time():
    """PIL may appear only inside functions: a module-level import would
    stop the port from importing where PIL is absent."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    bad = []
    for path in sorted((root / "rcgan_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(path.name, n) for n in names if n.split(".")[0] == "PIL"]
    assert bad == []
