"""The decomposition's host inputs go up through ``utils.devices.upload``
(pinned memory, an asynchronous copy) and keep their bits; K35's launch
arguments (``matdecomp.k35_arguments``) hold its float64 table.

On the CPU each entry point must give bit for bit what it gave when its
host arrays were made tensors with ``torch.as_tensor``; the card tests
(``tests/test_torch_cuda.py``) show that the same calls make no host
synchronisation there.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import matdecomp as md
from dexct_tpu_torch.ops import spectral as sp
from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum, xcom
from dexct_tpu_torch.physics.detector import photon_counting_response
from dexct_tpu_torch.physics.materials import BONE, TISSUE, WATER
from dexct_tpu_torch.pipeline import spectralct
from dexct_tpu_torch.system import FanBeamGeometry
from dexct_tpu_torch.tools.probe_k35 import K35_CASES, multibin_case
from dexct_tpu_torch.utils.tiny_cases import _three_materials

THR = [20.0, 34.0, 50.0, 70.0]


def _pcd_scan():
    """The tiny spectral case's photon-counting fan and 140 kV spectrum."""
    ct = FanBeamGeometry(N_channels=48, N_proj=48, eid=False,
                         detector=photon_counting_response(), gamma_fan=0.9,
                         SID=60.0, SDD=100.0)
    spec = kramers_spectrum(140.0)
    spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    return ct, spec


def _decompose_multibin_grid_as_tensor(sinos, ee, i0s, basis, **kw):
    """``decompose_multibin_grid`` with its arrays made tensors by
    ``torch.as_tensor``: the reference for its uploads."""
    sinos = torch.as_tensor(sinos, dtype=torch.float32)
    m, v, c = sinos.shape
    mus = np.stack([xcom.mixatten(b.matcomp, np.asarray(ee))
                    for b in basis])
    a = md.gauss_newton_solve(
        sinos.reshape(m, -1),
        torch.as_tensor(np.asarray(i0s), dtype=torch.float32),
        torch.as_tensor(mus, dtype=torch.float32), **kw)
    mask = md.air_mask(sinos[0])
    mats = torch.where(mask[None], torch.zeros(()),
                       a.T.reshape(len(basis), v, c))
    return mats.contiguous(), mask


def _bin_counts_as_tensor(paths, phantom, spec, i0s):
    mu = torch.as_tensor(phantom.materials.mu_table(spec.E),
                         dtype=torch.float32)
    i0_T = torch.as_tensor(np.asarray(i0s).T, dtype=torch.float32)
    counts = sp.counts_from_paths(paths.to(torch.float32), mu, i0_T)
    return torch.movedim(counts, -1, 0).contiguous()


@pytest.mark.parametrize("as_numpy", [True, False])
def test_decompose_multibin_grid_uploads_keep_the_bits(as_numpy):
    """Seeded NumPy counts (or the same counts as a CPU tensor), fluences
    and basis: the basis sinograms and air mask bit for bit the
    ``torch.as_tensor`` reference's."""
    ct, spec = _pcd_scan()
    i0s = md.pcd_bin_fluences(ct, spec, THR)
    mus = np.stack([xcom.mixatten(b.matcomp, spec.E)
                    for b in (TISSUE, BONE)])
    rng = np.random.default_rng(22)
    a = np.stack([rng.uniform(0, 20, 96), rng.uniform(0, 3, 96)], -1)
    counts = (np.exp(-a @ mus) @ i0s.T).T.reshape(4, 8, 12)
    counts[:, 0, :3] = counts.max()  # air rays for the mask
    sinos = counts if as_numpy else torch.as_tensor(counts,
                                                    dtype=torch.float32)
    got = md.decompose_multibin_grid(sinos, spec.E, i0s, (TISSUE, BONE),
                                     n_iters=12, device="cpu")
    want = _decompose_multibin_grid_as_tensor(counts, spec.E, i0s,
                                              (TISSUE, BONE), n_iters=12)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert bool(got[1].any()) and float(got[0][:, 0, :3].abs().max()) == 0


def test_decompose_sinograms_uploads_keep_the_bits():
    ct = FanBeamGeometry(N_channels=16, N_proj=8, eid=True)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    _, i0, mus = md.prepare_decomposition(ct, s1, s2)
    rng = np.random.default_rng(23)
    a = np.stack([rng.uniform(0, 30, 128), rng.uniform(0, 4, 128)], -1)
    counts = torch.as_tensor((np.exp(-a @ mus) @ i0.T).T.reshape(2, 8, 16),
                             dtype=torch.float32)
    got = md.decompose_sinograms(ct, counts[0], counts[1], s1, s2,
                                 n_iters=12)
    want = md.gauss_newton_solve(
        counts.reshape(2, -1), torch.as_tensor(i0, dtype=torch.float32),
        torch.as_tensor(mus, dtype=torch.float32), n_iters=12)
    mask = md.air_mask(counts[0])
    for k, g in enumerate(got):
        assert torch.equal(g, torch.where(mask, torch.zeros(()),
                                          want[:, k].reshape(8, 16)))


def test_image_domain_decomposition_uploads_keep_the_bits():
    ct, _ = _pcd_scan()
    s1, s2 = kramers_spectrum(80.0), kramers_spectrum(140.0)
    rng = np.random.default_rng(24)
    r1, r2 = rng.uniform(0.1, 0.4, (2, 16, 16)).astype(np.float32)
    got = md.image_domain_decomposition(r1, r2, s1, s2, ct, device="cpu")
    a_mat = np.zeros((2, 2))
    for i, spec in enumerate((s1, s2)):
        w = sp.effective_fluence(spec, ct)
        w = w / w.sum()
        for m, mat in enumerate(md.DEFAULT_BASIS):
            a_mat[i, m] = float(np.sum(w * mat.mass_atten(spec.E)))
    a_inv = torch.as_tensor(np.linalg.inv(a_mat), dtype=torch.float32)
    mu1, mu2 = (torch.as_tensor(r, dtype=torch.float32) for r in (r1, r2))
    want = (mu1 * a_inv[0, 0] + mu2 * a_inv[0, 1],
            mu1 * a_inv[1, 0] + mu2 * a_inv[1, 1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_simulate_pcd_spectral_uploads_keep_the_bits():
    """The tiny spectral case (``tiny_cases.spectral("pcd")``: a 48 x 48
    photon-counting fan through the 32^2 rods, 4 bins, pileup on) against
    the same pipeline with its bin tables and counts made tensors by
    ``torch.as_tensor``."""
    from dexct_tpu_torch.ops.fbp import fbp_recon
    from dexct_tpu_torch.ops.siddon import material_path_sinogram
    from dexct_tpu_torch.physics.pileup import (bin_mean_energies,
                                                bin_sum_redistribution)

    ct, spec = _pcd_scan()
    ph = _three_materials()
    basis = (WATER, BONE)
    got = spectralct.simulate_pcd_spectral(
        ct, ph, spec, THR, basis, 32, 20.0, 0.8, n_iters=12,
        pileup_tau=1e-9, device="cpu")
    i0s = md.pcd_bin_fluences(ct, spec, THR)
    counts = _bin_counts_as_tensor(
        material_path_sinogram(ph, ct, device="cpu"), ph, spec, i0s)
    route = bin_sum_redistribution(THR, bin_mean_energies(i0s, spec.E))
    counts, corrected = spectralct._acquire(counts, route, 1e-9,
                                            "paralyzable", True, "none",
                                            None)
    mats, mask = _decompose_multibin_grid_as_tensor(corrected, spec.E, i0s,
                                                    basis, n_iters=12)
    recons = torch.stack([fbp_recon(mats[k], ct, 32, 20.0, 0.8, "sinc")[0]
                          for k in range(2)])
    for g, w in ((got.counts, counts), (got.counts_corrected, corrected),
                 (got.basis_sinos, mats), (got.air_mask, mask),
                 (got.basis_recons, recons)):
        assert torch.equal(g, w)


def test_pcd_arrays_uploads_keep_the_bits():
    """The packed path's bin tables (``_pcd_arrays``, at pack time) are
    the float32 casts of the host tables."""
    from dexct_tpu_torch.physics.pileup import (bin_mean_energies,
                                                bin_sum_redistribution)

    ct, spec = _pcd_scan()
    arrays = {"mu_t2": None}
    i0s = spectralct._pcd_arrays(arrays, ct, spec, THR, (TISSUE, BONE),
                                 None, 1e-9, "none", torch.device("cpu"))
    mus = np.stack([xcom.mixatten(b.matcomp, np.asarray(spec.E))
                    for b in (TISSUE, BONE)])
    route = bin_sum_redistribution(THR, bin_mean_energies(i0s, spec.E))
    assert "mu_t2" not in arrays
    for key, host in (("i0_bins_T", np.asarray(i0s).T), ("dec_i0", i0s),
                      ("dec_mus", mus), ("pileup_route", route)):
        want = torch.as_tensor(np.asarray(host), dtype=torch.float32)
        assert arrays[key].dtype == torch.float32
        assert torch.equal(arrays[key], want)


@pytest.mark.parametrize("name", list(K35_CASES))
def test_k35_arguments_hold_a_float64_table(name):
    """K35's table, for each of the card tests' K35 cases: float64, each
    value the float32 row value cast exactly, rows of K + M (1 + K)
    (+ M T with "newton") values, the full grid then the warm rows, the
    warm rows bf16-exact when the warm phase runs in bf16."""
    thr, n_mats, kw = K35_CASES[name]
    counts, i0, mus = multibin_case(thr, n_mats, n_pix=64)
    (c, tables, scale, P, M, K, newton, e_full, e_warm, n_warm, n_pol,
     warm_bf16, warm_log, polish_log, lm, a_lo, a_hi, step_max, eps_init,
     clip) = md.k35_arguments(counts, i0, mus, **kw)
    assert (P, M, K) == (64, len(thr), n_mats)
    assert c.is_contiguous() and torch.equal(c, counts)
    sched = md._schedule(M, K, kw["n_iters"], 4, kw.get("method", "gn"),
                         kw.get("warm", "log"))
    assert (n_warm, n_pol, bool(warm_bf16), bool(warm_log),
            bool(polish_log), bool(newton)) == tuple(sched)
    T = K * (K + 1) // 2
    row = K + M * (1 + K) + (M * T if newton else 0)
    assert tables.dtype == torch.float64 and tables.is_contiguous()
    assert tables.numel() == (e_full + e_warm) * row
    assert torch.equal(tables.float().double(), tables)
    rows = tables.reshape(e_full + e_warm, row)
    _, scale_want, full, warm, _ = md._prepare(
        counts, i0, mus, kw["n_iters"], 4, 32, kw.get("method", "gn"),
        kw.get("warm", "log"))
    assert torch.equal(scale, scale_want)
    assert torch.equal(rows[:e_full], torch.cat(full, 1).double())
    warm_rows = torch.cat(warm, 1)
    if warm_bf16:
        assert torch.equal(rows[e_full:].to(torch.bfloat16).double(),
                           rows[e_full:])
        warm_rows = warm_rows.to(torch.bfloat16).float()
    assert torch.equal(rows[e_full:], warm_rows.double())
    assert (lm, a_lo, a_hi, eps_init, clip) == (
        float(kw.get("lm_damping", 0.0)), -20.0, 500.0, 1e-6, md._CLIP)
    assert step_max == float(kw.get("step_max", 5.0))
