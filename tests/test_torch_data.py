"""Port parity: the data pipeline vs shwd_tpu.data.

jax.random and torch streams differ, so the transform math is compared on
fixed draws (poses, noise and outliers made with numpy and handed to both
sides), and the random parts are checked for their ranges."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch import data as td
from shwd_torch.data import transforms as tt
from shwd_tpu import data as jd

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kinds", [("box", "ellipsoid", "cylinder", "cone"),
                                   ("composite",)])
def test_shape_bank_bit_equal(kinds):
    a = jd.shape_bank(9, 32, seed=7, kinds=kinds)
    b = td.shape_bank(9, 32, seed=7, kinds=kinds)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_load_dataset_and_mesh_code_bit_equal(tmp_path):
    """The synthetic fallback, the OFF reader + sampler, and the cache."""
    for split in ("train", "test"):
        assert np.array_equal(
            jd.load_dataset(16, split, cache_dir=str(tmp_path / "none"),
                            num_synthetic=12, seed=3, synthetic_kinds=("composite",)),
            td.load_dataset(16, split, cache_dir=str(tmp_path / "none"),
                            num_synthetic=12, seed=3, synthetic_kinds=("composite",)))
    root = "tests/fixtures/modelnet_mini"
    pa = jd.preprocess_modelnet(root, str(tmp_path / "a"), 20, "train")
    pb = td.preprocess_modelnet(root, str(tmp_path / "b"), 20, "train")
    assert np.array_equal(np.load(pa)["clouds"], np.load(pb)["clouds"])
    # the cache file wins once it exists
    cached = td.load_dataset(20, "train", modelnet_root=root,
                             cache_dir=str(tmp_path / "c"))
    again = td.load_dataset(20, "train", cache_dir=str(tmp_path / "c"))
    assert np.array_equal(cached, again) and cached.shape == (6, 20, 3)


def test_apply_pose_matches_jax():
    rng = np.random.default_rng(61)
    src = rng.normal(size=(4, 30, 3)).astype(np.float32)
    raw = rng.normal(size=(4, 7)).astype(np.float32)
    raw[:, :4] /= np.linalg.norm(raw[:, :4], axis=-1, keepdims=True)
    want = jd.apply_pose(jnp.asarray(src), jnp.asarray(raw))
    got = td.apply_pose(torch.from_numpy(src), torch.from_numpy(raw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_make_registration_batch_on_fixed_draws():
    """noise -> outliers -> pose with the same numpy draws on both sides:
    the JAX one-hot replacement and the port's scatter give the same
    batch."""
    rng = np.random.default_rng(62)
    b, n, k = 3, 20, 4
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    noise = (0.02 * rng.normal(size=(b, n, 3))).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b)])
    vals = rng.normal(size=(b, k, 3)).astype(np.float32)
    raw = rng.normal(size=(b, 7)).astype(np.float32)
    raw[:, :4] /= np.linalg.norm(raw[:, :4], axis=-1, keepdims=True)

    noisy = jnp.asarray(src + noise)
    onehot = jax.nn.one_hot(jnp.asarray(idx), n, dtype=noisy.dtype)
    mask = jnp.sum(onehot, axis=1)[..., None]
    noisy = noisy * (1 - mask) + jnp.einsum("bkn,bkd->bnd", onehot, jnp.asarray(vals))
    want = jd.apply_pose(noisy, jnp.asarray(raw))

    replaced = tt.replace_outliers(torch.from_numpy(src + noise),
                                   torch.from_numpy(idx), torch.from_numpy(vals))
    got = td.apply_pose(replaced, torch.from_numpy(raw))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def test_make_registration_batch_random_parts():
    """Ranges and shapes of the port's own draws: outliers replace exactly
    outlier_num points, the pose undoes the transform, the same generator
    seed gives the same batch."""
    cfg = td.TransformConfig(noise_sigma=0.0, outlier_num=5, outlier_sigma=3.0)
    src = torch.from_numpy(td.shape_bank(6, 40, seed=1))

    def make(seed):
        return td.make_registration_batch(torch.Generator().manual_seed(seed),
                                          src, src, cfg)

    batch = make(0)
    assert torch.equal(batch.source, make(0).source)
    assert not torch.equal(batch.source, make(1).source)
    assert batch.source.shape == (6, 40, 3) and batch.igt_rotation.shape == (6, 3, 3)
    # R^T (source - t) recovers the clean cloud except at the outliers
    back = torch.einsum("bji,bnj->bni", batch.igt_rotation,
                        batch.source - batch.igt_translation[:, None])
    moved = (back - src).norm(dim=-1) > 1e-4
    assert moved.sum(dim=1).tolist() == [5] * 6
    np.testing.assert_allclose(batch.igt_translation.norm(dim=-1).numpy(),
                               np.ones(6), rtol=1e-5)


@pytest.mark.parametrize("axes,fixed", [("xyz", False), ("y", False), ("x", True)])
def test_random_pose_respects_ranges(axes, fixed):
    from shwd_torch.ops.quaternion import quat_to_matrix, rotation_error_deg
    cfg = td.TransformConfig(angle_range_deg=30.0, translation_range=4.0,
                             rotation_axes=axes, fixed_angle=fixed)
    pose = td.random_pose_7d(torch.Generator().manual_seed(2), 64, cfg)
    assert pose.shape == (64, 7)
    np.testing.assert_allclose(pose[:, 4:].norm(dim=-1).numpy(), 2 * np.ones(64),
                               rtol=1e-5)
    angle = rotation_error_deg(quat_to_matrix(pose[:, :4]), torch.eye(3).expand(64, 3, 3))
    if fixed:
        np.testing.assert_allclose(angle.numpy(), 30 * np.ones(64), atol=1e-3)
    elif axes == "y":
        assert float(angle.max()) <= 30 + 1e-3
    else:
        assert float(angle.max()) <= 30 * 3 ** 0.5 + 1.0


def test_split_indices_and_batches(tmp_path):
    """The 80/20 split is the JAX package's for the same numpy seed; batches
    drop or keep the remainder as asked and live on the dataset's device."""
    kw = dict(source_point_num=16, target_point_num=24, num_synthetic=21,
              cache_dir=str(tmp_path / "mc"), synthetic_kinds=("composite",))
    jds = jd.RegistrationDataset(jd.DatasetConfig(**kw), "train")
    tds = td.RegistrationDataset(td.DatasetConfig(**kw), "train", device="cpu")
    assert np.array_equal(np.asarray(jds.sources), tds.sources.numpy())
    assert np.array_equal(np.asarray(jds.targets), tds.targets.numpy())
    jt, jv = jds.train_val_indices(np.random.default_rng(9))
    tt_, tv = tds.train_val_indices(np.random.default_rng(9))
    assert np.array_equal(jt, tt_) and np.array_equal(jv, tv) and len(tv) == 4
    gen = torch.Generator().manual_seed(0)
    sizes = [b.source.shape[0] for b in tds.batches(gen, tt_, 5, shuffle=False)]
    assert sizes == [5, 5, 5]
    batches = list(tds.batches(gen, tt_, 5, shuffle=True,
                               rng=np.random.default_rng(1), drop_remainder=False))
    assert [b.source.shape[0] for b in batches] == [5, 5, 5, 2]
    assert batches[0].source.shape == (5, 16, 3) and batches[0].target.shape == (5, 24, 3)
    # unshuffled targets are the bank rows in index order
    first = next(tds.batches(gen, tt_, 5, shuffle=False))
    assert torch.equal(first.target, tds.targets[torch.as_tensor(tt_[:5])])


def test_dataset_defaults_to_the_card(tmp_path):
    cfg = td.DatasetConfig(num_synthetic=4, cache_dir=str(tmp_path / "mc"))
    if torch.cuda.is_available():
        assert td.RegistrationDataset(cfg).sources.is_cuda
    else:
        with pytest.raises(RuntimeError):
            td.RegistrationDataset(cfg)
