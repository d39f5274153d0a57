"""The port's learned denoiser (learn/, inference on the CPU) against the
JAX package's: the vendored checkpoint, the flax-key reader, batched
inference and the CLI's --denoise stage.

Tolerances: the port's checkpoint copy is byte-identical; the loaded
weights are exactly the checkpoint's (HWIO -> OIHW is a transpose); the
denoised images agree to 1e-2 HU (two float32 convolution stacks of 8
layers, 48 channels, summed in different orders: measured ~3e-4 HU); the
CLI files are held to tests/test_torch_pipeline.py's TOL (denoised HU 1
HU, raw 1e-4 cm^-1)."""

import filecmp
import os

import numpy as np
import pytest
import torch

from dexct_tpu.learn import denoiser_io as j_io
from dexct_tpu_torch.learn import cnn as t_cnn
from dexct_tpu_torch.learn import denoiser_io as t_io
from dexct_tpu_torch.learn.train import HU_SCALE, apply_denoiser
from test_torch_cone import _cone_params
from test_torch_pipeline import REPO, _both_clis, _tiny_params


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hu_images(n=3, size=64, seed=0):
    """Seeded noisy HU images: a water disc in air, with soft-tissue noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    disc = np.hypot(yy - size / 2 + 0.5, xx - size / 2 + 0.5) < 0.4 * size
    base = np.where(disc, 0.0, -1000.0)
    return np.stack([base + rng.normal(0, 40 + 20 * k, (size, size))
                     for k in range(n)]).astype(np.float32)


def test_checkpoint_copy_is_byte_identical():
    jax_copy = os.path.join(REPO, "dexct_tpu", "learn", "weights",
                            "dncnn_default.npz")
    assert t_io.default_weights_path() == os.path.join(
        REPO, "dexct_tpu_torch", "learn", "weights", "dncnn_default.npz")
    assert filecmp.cmp(t_io.default_weights_path(), jax_copy, shallow=False)


def test_load_params_maps_every_key():
    """Every flax leaf lands in its layer with its shape: kernels HWIO ->
    OIHW, biases as they are; no leaf is left over."""
    model = t_io.load_params(t_io.default_weights_path())
    assert (model.features, model.depth) == (48, 8)
    assert not model.training
    with np.load(t_io.default_weights_path()) as z:
        stored = {k: z[k] for k in z.files if not k.startswith("__meta_")}
    seen = set()
    for i, conv in enumerate(model.convs):
        kernel = stored[t_io.flax_key(i, "kernel")]
        bias = stored[t_io.flax_key(i, "bias")]
        assert kernel.shape == (3, 3, conv.in_channels, conv.out_channels)
        np.testing.assert_array_equal(conv.weight.numpy(),
                                      kernel.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.numpy(), bias)
        seen |= {t_io.flax_key(i, "kernel"), t_io.flax_key(i, "bias")}
    assert seen == set(stored)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_params_refuses_a_bad_checkpoint(tmp_path, fault):
    with np.load(t_io.default_weights_path()) as z:
        arrs = {k: z[k] for k in z.files}
    key = t_io.flax_key(3, "kernel")
    if fault == "missing":
        del arrs[key]
        msg = "is missing"
    else:
        arrs[key] = arrs[key][:, :, :, :40]
        msg = "model expects"
    path = tmp_path / "bad.npz"
    np.savez(path, **arrs)
    with pytest.raises(ValueError, match=msg):
        t_io.load_params(str(path))


def test_dncnn_is_the_identity_at_initialisation():
    torch.manual_seed(0)
    model = t_cnn.DnCNN(features=8, depth=3)
    x = torch.randn(2, 16, 16, 1)
    torch.testing.assert_close(model(x), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="N, H, W, C"):
        model(x[0])


def test_denoise_hu_batch_matches_jax():
    """Three seeded 64^2 HU images through the vendored checkpoint in one
    batch, and one image alone."""
    imgs = _hu_images()
    want = j_io.denoise_hu_batch(imgs)
    got = t_io.denoise_hu_batch(torch.as_tensor(imgs))
    assert got.shape == imgs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    assert float(np.abs(want - imgs).max()) > 10.0  # it does denoise
    one = apply_denoiser(t_io.load_default_denoiser(), imgs[1])
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=1e-2)
    assert HU_SCALE == 1000.0


def test_denoise_cli_matches_jax(tmp_path):
    """--denoise on the tiny 2-D config: the 12 files and
    recon_denoised_{raw,HU} of both spectra."""
    out = _both_clis(tmp_path, _tiny_params(tmp_path), ["--denoise"], 16)
    assert len(list((out / "tiny").rglob("recon_denoised_*.bin"))) == 4


def test_denoise_cone_cli_matches_jax(tmp_path):
    """--denoise on a tiny cone config: every slice of both volumes in one
    forward pass."""
    out = _both_clis(tmp_path, _cone_params(tmp_path, "cone_beam"),
                     ["--denoise"], 16)
    (hu,) = (out / "tiny3d").rglob("80kV_1000uGy/recon_denoised_HU*.bin")
    raw = np.fromfile(hu, np.float32)
    assert raw.size % (32 * 32) == 0 and raw.size // (32 * 32) > 1


def test_resume_with_denoise(tmp_path, capsys):
    """A pair counts as complete only with its denoised images when
    --denoise is given, as in the JAX runner."""
    from dexct_tpu_torch.run import main as t_main

    argv = ["--params", str(_tiny_params(tmp_path)), "--iters", "2",
            "--device", "cpu", "--output", str(tmp_path / "o"),
            "--spectrum-dir", os.path.join(REPO, "input", "spectrum")]
    assert len(t_main(argv)) == 1
    assert len(t_main(argv + ["--resume", "--denoise"])) == 1  # not complete
    assert t_main(argv + ["--resume", "--denoise"]) == []
    assert "skipping completed" in capsys.readouterr().out
    (den,) = (tmp_path / "o").rglob("80kV*/recon_denoised_raw_float32.bin")
    den.unlink()
    assert len(t_main(argv + ["--resume", "--denoise"])) == 1
    assert t_main(argv + ["--resume"]) == []
