"""The port's FBP noise maps (``ops/noisemap.py``: the plain version of K25)
against the JAX package's, on the CPU.

Inputs: a 48^2 water cylinder (radius 4.5 cm) under a 64-channel, 48-view
fan with a photon-counting detector (the JAX tests' set-up), a 140 / 80 kV
Kramers pair and a linac / 80 kV pair at 3e4 counts per air ray, the
counts and decomposition computed once by the JAX package and fed to both.
Tolerances: the variance maps 1e-4 of their maximum (float32 sums over
views in another order; measured < 1e-6); the per-ray covariance 1e-4 of
each entry's maximum under Poisson weights (the 2 x 2 inverse divides by
a determinant that cancels about three digits, Fisher condition numbers
1.4e3-2.3e3; measured 2e-5), 1e-3 under the compound weights of an
energy-integrating detector (condition number 4.9e4: the JAX package and
the port lie 1.4e-4 and 2.4e-4 from a float64 evaluation of the same
formula, 4e-4 from each other); the log variance and the VMI map,
elementwise on the same inputs, 1e-6 relative.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexct_tpu.ops import noisemap as jn
from dexct_tpu.ops import spectral as j_spectral
from dexct_tpu.ops.matdecomp import decompose_sinograms
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics import linac_spectrum as j_linac
from dexct_tpu.pipeline.api import get_sino
from dexct_tpu.system import geometry as j_geo
from dexct_tpu.system.phantom import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import noisemap as tn
from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
from dexct_tpu_torch.physics import linac_spectrum as t_linac
from dexct_tpu_torch.system import geometry as t_geo

FAN = dict(N_channels=64, N_proj=48, gamma_fan=0.9, SID=60.0, SDD=100.0,
           h_iso=0.1)
N, FOV = 48, 12.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fan(eid=False):
    return (j_geo.FanBeamGeometry(eid=eid, **FAN),
            t_geo.FanBeamGeometry(eid=eid, **FAN))


def _spectra(high, jct):
    """(JAX, port) spectra of the pair, each at 3e4 counts per air ray."""
    out = []
    pairs = [((j_linac(), t_linac()) if high == "linac"
              else (j_kramers(140.0), t_kramers(140.0))),
             (j_kramers(80.0), t_kramers(80.0))]
    for js, ts in pairs:
        f = 3e4 / float(np.sum(j_spectral.effective_fluence(js, jct)))
        js.rescale_counts(f)
        ts.rescale_counts(f)
        out.append((js, ts))
    return out


_CACHE = {}


def _scan(high, eid=False):
    """Geometries, spectra, the JAX package's counts of both acquisitions
    and its basis sinograms [V, C, 2] (20 GN iterations)."""
    key = (high, eid)
    if key not in _CACHE:
        jct, tct = _fan(eid)
        (js1, ts1), (js2, ts2) = _spectra(high, jct)
        ph = j_cyl(N=48, dx=0.25, radius_cm=4.5)
        c1 = np.asarray(get_sino(jct, ph, js1)[0])
        c2 = np.asarray(get_sino(jct, ph, js2)[0])
        m1, m2 = decompose_sinograms(jct, jnp.asarray(c1), jnp.asarray(c2),
                                     js1, js2, n_iters=20)
        a = np.stack([np.asarray(m1), np.asarray(m2)], -1)
        _CACHE[key] = (jct, tct, (js1, js2), (ts1, ts2), c1, c2, a)
    return _CACHE[key]


def _close_max(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    big = np.abs(want).max()
    assert big > 0
    assert np.abs(got - want).max() <= tol * big


@pytest.mark.parametrize("explicit", [False, True])
def test_log_variance_matches_jax(explicit):
    c = np.array([[1e-40, 3.0, 100.0, 1e4]], np.float32)
    v = np.array([[2.0, 5.0, 400.0, 1e4]], np.float32) if explicit else None
    want = np.asarray(jn.log_variance(jnp.asarray(c), None if v is None
                                      else jnp.asarray(v)))
    got = tn.log_variance(torch.as_tensor(c), None if v is None
                          else torch.as_tensor(v))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("case", ["raw", "hu", "compound_var", "ramp_hann"])
def test_fbp_variance_map_matches_jax(case):
    jct, tct, _, _, _, c2, _ = _scan("kramers")
    kw = {}
    if case == "hu":
        kw["mu_water_eff"] = 0.2
    if case == "compound_var":
        kw["var_counts"] = 1.7 * c2
    args = (N, FOV) + ((1.0, "hann") if case == "ramp_hann" else (0.8,))
    want = np.asarray(jn.fbp_variance_map(
        jnp.asarray(c2), jct, *args, **{k: (jnp.asarray(v) if k ==
                                             "var_counts" else v)
                                        for k, v in kw.items()}))
    got = tn.fbp_variance_map(torch.as_tensor(c2), tct, *args, **{
        k: (torch.as_tensor(v) if k == "var_counts" else v)
        for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close_max(got, want, 1e-4)


def test_fbp_variance_map_runs_on_the_requested_device():
    """A host array runs on ``device``; a CPU tensor on the CPU whatever
    ``device`` says (the entry points follow the sinogram's tensor)."""
    _, tct, _, _, _, c2, _ = _scan("kramers")
    a = tn.fbp_variance_map(c2, tct, N, FOV, device="cpu")
    b = tn.fbp_variance_map(torch.as_tensor(c2), tct, N, FOV)
    assert a.device.type == b.device.type == "cpu"
    assert torch.equal(a, b)


def test_fbp_variance_map_refuses_unmodeled_geometries():
    par = t_geo.ParallelBeamGeometry(N_channels=32, N_proj=16, h_iso=0.1,
                                     eid=False, detector_width=10.0)
    ffs = t_geo.FanBeamGeometry(ffs="inplane", **FAN)
    for ct in (par, ffs):
        with pytest.raises(ValueError, match="fan-beam"):
            tn.fbp_variance_map(torch.ones((16, 32)), ct, 32, 10.0)


@pytest.mark.parametrize("high,compound,tol", [("kramers", False, 1e-4),
                                               ("linac", False, 1e-4),
                                               ("linac", True, 1e-3)])
def test_decomposition_covariance_matches_jax(high, compound, tol):
    """Poisson and compound-EID (an energy-integrating detector) CRLB
    covariances, each entry within ``tol`` of its maximum magnitude (the
    module docstring gives each tolerance's reason)."""
    jct, tct, js, ts, _, _, a = _scan(high, eid=compound)
    want = np.asarray(jn.decomposition_covariance(jnp.asarray(a), jct, *js,
                                                  compound=compound))
    got = tn.decomposition_covariance(torch.as_tensor(a), tct, *ts,
                                      compound=compound).numpy()
    assert got.shape == want.shape == a.shape[:2] + (2, 2)
    for m in range(2):
        for n in range(2):
            big = np.abs(want[..., m, n]).max()
            assert np.abs(got[..., m, n] - want[..., m, n]).max() \
                <= tol * big
    # the classic anticorrelation, as in the JAX test
    assert (got[:, 28:36, 0, 1] < 0).all()


def test_decomposition_covariance_blocks_of_views():
    """The view blocks of the port's covariance change nothing: one block
    and blocks of 7 views give the same bits."""
    _, tct, _, ts, _, _, a = _scan("kramers")
    whole = tn.decomposition_covariance(torch.as_tensor(a), tct, *ts)
    old = tn._COV_VIEWS
    try:
        tn._COV_VIEWS = 7
        blocked = tn.decomposition_covariance(torch.as_tensor(a), tct, *ts)
    finally:
        tn._COV_VIEWS = old
    assert torch.equal(whole, blocked)


@pytest.mark.parametrize("high", ["kramers", "linac"])
def test_basis_and_vmi_variance_maps_match_jax(high):
    """The three basis maps (one K25 launch of three fields on the card)
    at 1e-4 of each map's maximum, fed the JAX package's covariance; the
    VMI map on the JAX maps at 40, 70 and 140 keV to 1e-6."""
    jct, tct, js, _, _, _, a = _scan(high)
    cov = np.asarray(jn.decomposition_covariance(jnp.asarray(a), jct, *js))
    want = [np.asarray(x) for x in jn.basis_variance_maps(
        jnp.asarray(cov), jct, N, FOV, 0.8)]
    got = tn.basis_variance_maps(torch.as_tensor(cov), tct, N, FOV, 0.8)
    for g, w in zip(got, want):
        _close_max(g, w, 1e-4)
    for e0 in (40.0, 70.0, 140.0):
        vw = np.asarray(jn.vmi_variance_map(*want, e0))
        vg = tn.vmi_variance_map(*[torch.as_tensor(x) for x in want], e0)
        np.testing.assert_allclose(vg.numpy(), vw, rtol=1e-6,
                                   atol=1e-6 * np.abs(vw).max())


def test_fan_backproject_var_plain_matches_jax_per_field():
    """K25's plain version with three fields equals the JAX program run on
    each field alone, within 1e-4 of the maximum, at a partial rotation's
    dbeta and an odd matrix."""
    from dexct_tpu.ops.noisemap import _fan_backproject_var as j_bp

    rng = np.random.default_rng(25)
    r0 = rng.uniform(0.1, 1.0, (3, 40, 32)).astype(np.float32)
    r1 = rng.uniform(-0.3, 0.3, (3, 40, 32)).astype(np.float32)
    betas = np.linspace(0.0, 4.0, 40).astype(np.float32)
    args = (60.0, 0.9 / 32, 37, 14.0)
    got = tn._fan_backproject_var(torch.as_tensor(r0), torch.as_tensor(r1),
                                  torch.as_tensor(betas), *args,
                                  dbeta=0.1)
    for k in range(3):
        want = np.asarray(j_bp(jnp.asarray(r0[k]), jnp.asarray(r1[k]),
                               jnp.asarray(betas), *args, dbeta=0.1))
        _close_max(got[k], want, 1e-4)
    with pytest.raises(ValueError, match="1 or 3 fields"):
        tn._fan_backproject_var(torch.as_tensor(r0[:2]),
                                torch.as_tensor(r1[:2]),
                                torch.as_tensor(betas), *args)


def test_vmi_numpy_maps_run_on_the_requested_device():
    """NumPy basis maps run on ``device`` ("cpu" here) and give what CPU
    tensors give; with no ``device`` they go to the card, so without one
    they raise."""
    rng = np.random.default_rng(3)
    maps = [rng.uniform(0.5, 2.0, (8, 8)).astype(np.float32),
            rng.uniform(0.5, 2.0, (8, 8)).astype(np.float32),
            rng.uniform(-0.4, 0.0, (8, 8)).astype(np.float32)]
    got = tn.vmi_variance_map(*maps, 70.0, device="cpu")
    assert got.device.type == "cpu"
    want = tn.vmi_variance_map(*[torch.as_tensor(m) for m in maps], 70.0)
    assert torch.equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tn.vmi_variance_map(*maps, 70.0)


# ---------------------------------------------------------------------------
# The JAX package's reading of chip_smoke.py's VMI noise curve (a script)
# ---------------------------------------------------------------------------

def vmi_reference():
    """The JAX package's VMI noise curve of ``chip_smoke.py``'s noise-map
    path at half its resolution (the reading VMI_MIN_KEV is set from), run
    as a script from the repository's root (~1 min, < 2 GB):

        PYTHONPATH=. python tests/test_torch_noisemap.py

    The reference protocol (input/params.txt: detunedMV at 9 and 80 kV at
    1 mGy) with its 256^2 pelvis at 0.2 cm as every other label (128^2 at
    0.4 cm), 400 channels and 500 views, reconstructed on 256^2 over the
    same 50 cm: the exact counts, 50 Gauss-Newton iterations, the
    decomposition covariance, the basis maps and the VMI map every 5 keV
    from 40 to 300; prints the median variance over the path's body pixels
    at each energy and the energy of the minimum."""
    import json
    import os

    from dexct_tpu.pipeline.runner import (_resolve_spectrum,
                                           default_generators)
    from dexct_tpu.system.config import _build_geometry, read_parameter_file
    from dexct_tpu.system.phantom import VoxelPhantom as JPhantom

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    params = os.path.join(repo, "input", "params.txt")
    base = json.loads(open(params).read())
    base["detector_filename"] = os.path.join(repo, base["detector_filename"])
    old = os.getcwd()
    os.chdir(repo)
    try:
        ref = read_parameter_file(params)[0].phantom
    finally:
        os.chdir(old)
    ph = JPhantom("pelvis", np.ascontiguousarray(ref.labels[:, ::2, ::2]),
                  ref.materials, 0.4, 0.4, 0.4)
    ct = _build_geometry(dict(base, N_channels=400, N_projections=500))
    n, fov = 256, 50.0
    gens = default_generators()
    spec_dir = os.path.join(repo, "input", "spectrum")
    s1, s2 = (_resolve_spectrum(name, dose, ct, spec_dir, gens)
              for name, dose in (("detunedMV", 9.0), ("80kV", 1.0)))
    c1, c2 = (get_sino(ct, ph, s)[0] for s in (s1, s2))
    m1, m2 = decompose_sinograms(ct, c1, c2, s1, s2, n_iters=50)
    cov = jn.decomposition_covariance(jnp.stack([m1, m2], -1), ct, s1, s2)
    maps = jn.basis_variance_maps(cov, ct, n, fov, 0.8)
    body = np.asarray(chip_smoke.body_pixels(ph, n, fov))
    curve = [float(np.median(np.asarray(jn.vmi_variance_map(*maps, e))[body]))
             for e in chip_smoke.VMI_KEV]
    print("VMI noise (median HU^2 over the body): " + ", ".join(
        f"{e:g} keV {c:.4g}" for e, c in zip(chip_smoke.VMI_KEV, curve)))
    print(f"minimum at {chip_smoke.VMI_KEV[int(np.argmin(curve))]:g} keV")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    vmi_reference()
