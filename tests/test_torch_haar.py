"""The port's Haar transform (`ops/haar.py`) and `Haar_PKLDataset` against
the JAX package's.

The ops on the same seeded numpy inputs within 1e-6 (an exact orthonormal
2x2 transform in float32), and the properties the JAX `tests/test_haar.py`
holds, as cases of one parametrised test.  The datamodule's batches in every
``data.map`` mode, test and train (shuffled, flipped) splits, against JAX's
`HaarPKLDataModule` on a written pklv4 fixture, bit for bit in float32.
"""

import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from conditional_score_diffusion_tpu.ops import haar as jax_haar  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs.base import Config  # noqa: E402
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import PKLDataModule  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops import haar  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


OPS = [
    ("haar_forward_2d", lambda m, x: m.haar_forward_2d(x), (2, 16, 16, 3)),
    ("haar_inverse_2d", lambda m, x: m.haar_inverse_2d(x), (2, 8, 8, 12)),
    ("permute_forward", lambda m, x: m.permute_channels(x, True), (2, 4, 4, 12)),
    ("permute_backward", lambda m, x: m.permute_channels(x, False), (2, 4, 4, 36)),
    ("haar_forward", lambda m, x: m.haar_forward(x), (2, 16, 12, 9)),
    ("haar_backward", lambda m, x: m.haar_backward(x), (2, 8, 8, 12)),
    ("get_dc_coefficients", lambda m, x: m.get_dc_coefficients(x), (3, 8, 8, 3)),
    ("get_hf_coefficients", lambda m, x: m.get_hf_coefficients(x), (3, 8, 8, 3)),
    ("multi_level_approx", lambda m, x: m.multi_level_haar_forward(x, 3)[0], (2, 32, 32, 3)),
    ("multi_level_detail", lambda m, x: m.multi_level_haar_forward(x, 3)[1], (2, 32, 32, 3)),
]


@pytest.mark.parametrize("name,op,shape", OPS, ids=[o[0] for o in OPS])
def test_op_matches_jax(name, op, shape):
    x = _rand(shape, seed=len(name))
    want = np.asarray(op(jax_haar, jnp.asarray(x)))
    got = op(haar, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _orthonormal():
    np.testing.assert_allclose(haar._H @ haar._H.T, np.eye(4), atol=1e-7)
    assert np.array_equal(haar._H, jax_haar._H)


def _round_trip():
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32))
    np.testing.assert_allclose(haar.haar_backward(haar.haar_forward(x)), x, atol=TOL)
    np.testing.assert_allclose(haar.haar_inverse_2d(haar.haar_forward_2d(x)), x, atol=TOL)


def _energy():
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 8, 8, 3).astype(np.float32))
    z = haar.haar_forward(x)
    np.testing.assert_allclose(float((x.double() ** 2).sum()), float((z.double() ** 2).sum()), rtol=1e-5)


def _dc_of_constant():
    c = torch.full((1, 4, 4, 3), 0.5)
    np.testing.assert_allclose(haar.get_dc_coefficients(c), 1.0, atol=TOL)  # twice the value
    np.testing.assert_allclose(haar.get_hf_coefficients(c), 0.0, atol=TOL)


def _permute_round_trip():
    z = torch.from_numpy(np.random.RandomState(2).rand(1, 4, 4, 12).astype(np.float32))
    assert torch.equal(haar.permute_channels(haar.permute_channels(z, True), False), z)


def _band_major():
    x = np.random.RandomState(3).rand(1, 8, 8, 3).astype(np.float32)
    dc = haar.haar_forward(torch.from_numpy(x))[..., :3].numpy()
    blocks = x.reshape(1, 4, 2, 4, 2, 3).mean(axis=(2, 4)) * 2  # the 2x2 block's mean, doubled
    np.testing.assert_allclose(dc, blocks, atol=1e-5)


def _multi_level_shapes():
    a, d = haar.multi_level_haar_forward(torch.zeros(2, 32, 32, 3), 3)
    assert a.shape == (2, 4, 4, 3) and d.shape == (2, 4, 4, 9)
    a, d = haar.multi_level_haar_forward(torch.zeros(2, 32, 32, 3), 0)
    assert a.shape == (2, 32, 32, 3) and d is None


PROPERTIES = [_orthonormal, _round_trip, _energy, _dc_of_constant, _permute_round_trip, _band_major,
              _multi_level_shapes]


@pytest.mark.parametrize("prop", PROPERTIES, ids=[p.__name__.strip("_") for p in PROPERTIES])
def test_haar_properties(prop):
    prop()


def _write(path, images):
    with open(path, "wb") as f:
        pickle.dump(images, f)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """``toyhaar`` at 32px GT and 16px ``_X2`` LQ, three splits of 10."""
    base = tmp_path_factory.mktemp("haar_data")
    d = base / "toyhaar"
    d.mkdir()
    rng = np.random.RandomState(5)
    for phase in ("train", "val", "test"):
        _write(str(d / f"toyhaar-{phase}.pklv4"), [rng.randint(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(10)])
        _write(str(d / f"toyhaar-{phase}_X2.pklv4"), [rng.randint(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(10)])
    return str(base)


def _haar_data(base_dir, mapping, level, backend):
    fields = dict(
        datamodule="Haar_PKLDataset", dataset="toyhaar", base_dir=base_dir, map=mapping, level=level, scale=2,
        use_flip=True, use_crop=False, use_rot=False,
    )
    if backend == "jax":
        import ml_collections

        return ml_collections.ConfigDict(dict(
            seed=7, data=fields, training=dict(batch_size=4), eval=dict(batch_size=3),
        ))
    return Config(seed=7, data=Config(**fields), training=Config(batch_size=4), eval=Config(batch_size=3))


@pytest.mark.parametrize("level", [0, 1.0])
@pytest.mark.parametrize("mapping", ["approx to detail", "bicubic to approx", "bicubic to haar"])
def test_haar_batches_match_jax(fixture_dir, mapping, level):
    from conditional_score_diffusion_tpu.data import create_datamodule

    jm = create_datamodule(_haar_data(fixture_dir, mapping, level, "jax"))
    jm.setup()
    port = PKLDataModule(_haar_data(fixture_dir, mapping, level, "torch"))
    assert port.reads_lq == (mapping != "approx to detail")

    want_test, got_test = list(jm.test_iterator()), list(port.test_iterator())
    assert len(got_test) == len(want_test) == 3
    train_j, train_p = jm.train_iterator(), port.train_iterator()
    pairs = list(zip(got_test, want_test)) + [(next(train_p), next(train_j)) for _ in range(5)]
    for got, want in pairs:
        for k in ("x", "y"):
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), (mapping, k, np.abs(got[k] - want[k]).max())
    size = 32 // 2 ** (int(level) + 1)
    x_channels = {"approx to detail": 9, "bicubic to approx": 3, "bicubic to haar": 12}[mapping]
    assert got_test[0]["x"].shape == (3, size, size, x_channels)


def test_approx_to_detail_reads_no_lq_file(fixture_dir, tmp_path):
    """The detail-given-approximation map needs the GT file alone."""
    d = tmp_path / "toyhaar"
    d.mkdir()
    with open(os.path.join(fixture_dir, "toyhaar", "toyhaar-test.pklv4"), "rb") as f:
        (d / "toyhaar-test.pklv4").write_bytes(f.read())
    batches = list(PKLDataModule(_haar_data(str(tmp_path), "approx to detail", 1, "torch")).test_iterator())
    assert len(batches) == 3 and batches[0]["x"].shape == (3, 8, 8, 9)
    with pytest.raises(FileNotFoundError):
        list(PKLDataModule(_haar_data(str(tmp_path), "bicubic to haar", 1, "torch")).test_iterator())
