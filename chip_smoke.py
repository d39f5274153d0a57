#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dexct_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--witness DIR]

Needs one CUDA device, the CUDA toolkit (nvcc) and Triton; imports nothing
of JAX.  Phases, each of which raises on failure:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: nvcc builds kernels K1, K3-K13, K15-K27, K29-K33 and K35-K39
   from ``dexct_tpu_torch/csrc`` (one nvcc per source, all at once); Triton
   compiles K2, K14, K28 and K34.
3. Each kernel against its plain PyTorch version on the card, on the
   inputs its path gives it, with the error, both times, the kernel's
   bound (the larger of its bytes over 3.35 TB/s and its float32
   operations over 67 TFLOP/s, counted from this run's inputs) and, where
   one PyTorch call computes the same function, that call's time: K1-K4 on
   the exact path and K5-K8 on the default path at the reference protocol
   (``input/params.txt``: 256^2 pelvis, 1000 views x 800 channels, 50 GN
   iterations, four 512^2 images; K7's yardstick a complex CSR product);
   K9 on the same fan rays through ``pelvis_analytic()``; K10 and K11 on
   the cone config (360 views x 16 rows x 256 channels through a 256^2 x
   32 pelvis, 16 slices of 256^2); K12 on the helical one (720 views over
   two turns, pitch 3 cm, through a 256^2 x 48 pelvis, 19 slices); K2 and
   K3 once more on each 3-D config's own [V, R, C, M] paths and counts,
   timed apart, and K10 on the helical rays.  The stateless 3-D paths: K13
   on the flat-panel config, K16 (and K11 on its enlarged 258^2 x 60
   gantry grid) on the 15-degree tilted config (K16 bitwise its plain
   version, allocating nothing beyond its output, timed at four block
   widths), K12 with the z flying focal spot's nonzero row offsets at
   pitch 0 on the z-FFS cone config, and K14 and K15 on the helical
   config's Katsevich chain (14 slices).  K17 at the
   JAX package's z-stack workload (1000 x 800 rays through 8 slices of the
   512^2 pelvis, rolled), also bitwise against K1 on each slice (K1 over
   the 8 slices is its yardstick); K5 at 16 taps on the in-plane FFS plan
   of the reference protocol (500 x 1600 bins).  K12 in each of its six
   gFDK weightings on the helical config; K18 and K19 (the exact 3-D
   projector and its adjoint) on the cone config's rays and mu[labels] at
   60 keV, K18 also against K10's paths . mu and K19 through the
   dot-product identity, both against the system matrix's CSR product on
   every tenth view, each with its device time under a CUDA graph; K19's
   transposed table built by its kernels against the plain builder's,
   field for field, with its build time, bytes and padding; K19 over that
   table twice (bitwise equal) and, over its own table, bitwise against the
   CPU's plain version on every 30th view; K5 at 4 taps and K20 (the PI
   method) on the helical config's 60 keV sinogram.  K21 and K22 (the
   adjoints of K7 and K8) at the reference protocol's Fourier plan, each
   also against its forward kernel through the dot-product identity (K22
   over the plan's transposed taps, whose build time is printed, two
   launches bitwise equal, and read against the CPU's index_add_), then
   the whole projector's
   <A x, y> = <x, A^T y>; K23 (the 2-D dose map) on input/params.txt's 80
   kV scan at every 10th view, K24 (the 3-D one) on the cone and helical
   configs at every 30th and 60th view (each with its device time by
   kernel under torch.profiler and its peak memory above its inputs).
   K25 (the variance backprojection)
   at the reference protocol on the 80 kV exact-path counts (one field)
   and on the basis covariance of their decomposition (three fields); K26
   (fan-beam single scatter) on both acquisitions at every 50th view and
   K27 (cone beam) on the cone config at every 45th, each plain version on
   two of those views, and the N_rows = 1 cone against the fan.  K28 (the
   table-indexed counts) on the JAX study's bowtie (31 levels x 800
   channels) at the reference protocol, both spectra, with and without the
   second-moment table, and on the anode heel's 16 rows at the cone
   config; K29 (the grouped Gauss-Newton solve) on the 31 bowtie groups
   (50 iterations) and the 16 heel rows, and with one group bitwise
   against K3.  K30 (the motion-compensated fan backprojection) on the
   motion path's filtered 80 kV sinogram of the breathing pelvis and its
   true track, and at zero pose bitwise against K4; K31 (the gated
   backprojection) on the gated path's 4000-view thorax scan with its four
   gates in one launch, and with all-ones weights over one turn against K4
   where every view's fan covers the pixel; K32 and K33 (the
   motion-compensated cone FDK and helical gFDK) on the cone config's
   z-breathing stack and the helical config's stack under a 1.6 cm drift.
   K34 (the photon-counting bins' counts) on the exact trace of the
   reference protocol as a PCD scan with the packed path's 4 bins and with
   the K-edge pelvis's 6 bins and 8 materials, and K35 (the general Newton
   decomposition) on those counts (M = 4, K = 2, 10 iterations; M = 6, K =
   4, 60), and at (2, 2) with K3's schedule beside K3.  K36 and K37 (the
   afterglow recursion and its inverse) on the realistic path's bowtie
   counts of both acquisitions [1000, 800] and the cone config's 80 kV
   counts [360, 16, 256] with its two traps and warm start (bitwise
   reported; apply then correct must round-trip; K36's yardstick the
   cold-start lag as one FFT convolution); K38 and K39 (the gather-rate
   probe) on the JAX tool's 800-entry table at 2^20 and 2^24 indices and
   K39 on the 512^2 label table, bit for bit against ``tab[idx]``.
4. The paths: the default and the exact path through
   ``dexct_tpu_torch.run.main`` on ``input/params.txt``, then the cone,
   helical, flat-panel, tilted, z-FFS and Katsevich configs, the
   reference protocol with an in-plane flying focal spot and as a
   parallel-beam config, and the default path with ``--bhc --denoise``
   through the same CLI, each twice (the second call is steady state); the
   analytic projector through the library (``pack_dect(projector=
   'analytic', recon='parallel')`` + ``dect_step`` on the reference
   protocol with ``pelvis_analytic()``), twice; the z-stack through the
   library (``pack_zstack`` + ``zstack_step`` at the K17 workload,
   ``projector='siddon', recon='parallel'``), twice; then the library
   paths of the helical study and iterative reconstructors: the helical
   config through ``pack_cone_dect(weighting=...)`` + ``cone_dect_step``
   ('pair' twice, 'td', 'short'), a 60 keV scan of the cone config
   through an FDK warm start, ``cone_pwls_recon`` and ``cone_cg_recon``
   (twice, with each run's peak device memory; K19's table built once per
   reconstruction, and its share of one more profiled run), and the
   helical config's 60 keV scan through
   ``helical_pi_reconstruct`` (twice).  Every launch counter
   is set to 0 just before a path and read just after it: each kernel of
   the path must have launched, and no other.  Each path's outputs are
   checked (exact sizes, finite values, air ~ -1000 HU; the z-stack's
   slices 0 and 7 against single-slice steps), and the stages of the 3-D,
   composed 2-D, BHC/denoise and z-stack paths are timed once more with the
   device's busy share; the PWLS path must read water in the bladder within
   5 % with noise below 0.6 x FDK's, the PI path the helical gFDK's
   bladder within 50 HU, and each weighting the air and body readings of
   the JAX package's reconstruction of the same sinograms within 2 HU
   (``--witness DIR`` writes those sinograms and the slices read, for
   ``tests/test_torch_cone.py``).  Then three more library paths, each
   twice: ``iterative_2d`` (the reference protocol's 60 keV scan, CG 30,
   SIRT 50 and PWLS 60 iterations: CG must read the bladder within 3 %,
   PWLS within 5 % with noise below 0.6 x the FBP's), ``onestep`` (the
   default path's two-step result refined by 300 Adam iterations: the data
   loss must fall and the bladder's tissue density stay within 5 %) and
   ``dose`` (the 2-D maps of both acquisitions, the cone and helical 3-D
   maps: each deposited energy within 5 % of the beam energy removed; each
   map's peak device memory printed),
   ``noise_map`` (the reference protocol's exact counts and decomposition,
   both acquisitions' FBP variance maps, the decomposition's CRLB
   covariance, the basis maps and the VMI noise curve at 40-300 keV: the
   80 kV map within 10 % of a 64-draw Poisson ensemble through K4 in the
   body, the VMI curve falling over 40-140 keV and its minimum strictly
   inside, within 15 keV of the JAX package's) and ``scatter`` (single scatter
   of both acquisitions and of the cone config, the kernel-superposition
   model and its correction on the 80 kV counts: scatter finite and >= 0,
   each in-object SPR within 1.5x of the JAX package's and larger on the
   cone, the
   correction within 2 %).  Then the scanner-realism paths, each twice with
   its stages timed: ``realistic`` (``simulate_dect_realistic`` at the
   reference protocol with the JAX study's bowtie and the JAX tests'
   five-stage chain, with no noise and with compound noise: the chain's
   round trip, the bowtie run under MTF + gains against the clean
   no-bowtie basis sinogram, K29 against K3's central-spectrum solve, the
   air and the bladder after the bowtie water BHC), ``tcm``
   (``auto_tcm_profile`` + ``simulate_tcm_dect`` with no noise, equal to
   ``simulate_dect``, and with compound noise and an electronic floor) and
   ``heel`` (``simulate_cone_dect(heel=)`` on the cone config: d0 = 0 bit
   for bit the heel-free run, the row-grouped solve 5x closer to the
   heel-free basis sinogram than K3's).  Then the patient-motion paths,
   each twice: ``motion`` (the breathing pelvis at the reference
   protocol: ``material_path_sinogram_motion``, counts, decomposition,
   ``fbp_recon_motion`` of the four sinograms, ``estimate_translation``,
   ``estimate_motion_joint`` at 800 iterations and
   ``onestep_spectral_recon(motion=)`` at 300: the compensated images at
   least MOTION_RATIO_REF times closer to the static image than the
   uncorrected ones, both tracks' errors within MOTION_TRACK_REF's bands of
   the JAX package's and the joint one below the centroid one, the
   one-step loss falling, air ~ -1000 HU), ``gated`` (a breathing thorax
   over four turns, ``gated_series`` with four gates: the gate at the pose
   extreme under 0.6x the ungated lung error) and ``motion_3d`` (the cone
   config under a 0.5 cm and the helical config under a 1.6 cm z drift
   through ``fdk_reconstruct_motion`` and
   ``helical_fdk_reconstruct_motion``: zero motion against the static
   reconstructions, compensated below uncorrected and on the helix at
   least the JAX package's ratios, the compensated air ~ -1000 HU on the
   cone and at the JAX package's -1129 HU on the helix).  Then the
   spectral paths: ``spectral`` (the reference protocol as a photon-
   counting scan through ``pack_pcd_spectral`` + ``pcd_step`` with pileup,
   noisy and noiseless: the tissue ROI ~ 1.06 g/cm^3; the K-edge scan of
   a water cylinder with iodine and gadolinium rods through
   ``simulate_pcd_spectral``: each rod its agent at 0.010 and not the
   other, and the JAX package's half-resolution reading, within 0.002, the
   70 keV VMI within 2 % of water; the same rods in the pelvis, read
   beside the JAX package's), ``spectral_cone`` (the cone config as a PCD
   scan, packed and stateless, and the helical config packed: the tissue
   ROI ~ 1.06 g/cm^3) and ``acquisition_modes`` (kV switching, dual source
   with cross-scatter corrected, dual layer at the reference protocol: air
   ~ -1000 HU, the tissue ROI ~ 1.06 g/cm^3).  Then ``gather_probe``
   (``dexct_tpu_torch.tools.bench_gather.main`` at 2^24 lookups: K38 and
   K39 only) and ``sweep``, twice: the JAX package's dose study
   (``dose_sweep`` over five doses with compound noise and two seeds at
   the reference protocol's width, read through the port's ``analysis``:
   the noise-dose exponent and the VMI(70) contrast held to the committed
   JAX readings; K1, K2, K3, K5, K6 only) and BASELINE config 5's width
   (1440 views x 1600 channels through the 1024^2 pelvis: noiseless doses
   equal, ramp sharpness ordered, slice 0 equal to ``dect_step``, the
   empty slice air; K1-K4 only), its stages timed with the device's busy
   share.  The realistic path's afterglow stages must launch K36 or K37
   exactly once each.
5. A 64^2 config through the port on ``--device cpu`` and ``--device
   cuda`` under every 2-D path's flags and configuration, tiny versions of
   every 3-D path, a tiny z-stack, and tiny versions of the six library
   paths above, tiny noise maps and fan and cone scatter, tiny versions
   of the three realism paths, of the three motion paths, of the
   spectral paths and of the sweeps; every output agrees to the pipeline
   tolerances.

The last two lines of standard output are the kernels' JSON record and the
device JSON line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARAMS = ROOT / "input" / "params.txt"
SPECTRA = ROOT / "input" / "spectrum"

# name -> (route, source, TPU program replaced, tolerance statement)
KERNELS = {
    "siddon_trace": ("cuda", "dexct_tpu_torch/csrc/siddon_trace.cu",
                     "dexct_tpu/ops/siddon.py:98", "max abs <= 1e-4 cm"),
    "spectral_counts": ("triton", "dexct_tpu_torch/ops/spectral.py",
                        "dexct_tpu/ops/spectral.py:67", "max rel <= 1e-5"),
    "gauss_newton": ("cuda", "dexct_tpu_torch/csrc/gauss_newton.cu",
                     "dexct_tpu/ops/matdecomp.py:333",
                     "max |d| / max(|a|, 1) <= 1e-4"),
    "fan_backproject": ("cuda", "dexct_tpu_torch/csrc/fan_backproject.cu",
                        "dexct_tpu/ops/fbp_fast.py:53",
                        "max abs <= 1e-4 cm^-1"),
    "rebin_to_parallel": ("cuda", "dexct_tpu_torch/csrc/gather_taps.cu",
                          "dexct_tpu/ops/fbp_fast.py:184",
                          "max abs <= 1e-5 x max |plain|"),
    "parallel_backproject": ("cuda",
                             "dexct_tpu_torch/csrc/parallel_backproject.cu",
                             "dexct_tpu/ops/fbp_fast.py:277",
                             "max abs <= 1e-4 cm^-1"),
    "kb_sample": ("cuda", "dexct_tpu_torch/csrc/kb_sample.cu",
                  "dexct_tpu/ops/fourier.py:258",
                  "max abs <= 1e-5 x max |plain|"),
    "resample_to_fan": ("cuda", "dexct_tpu_torch/csrc/gather_taps.cu",
                        "dexct_tpu/ops/fourier.py:397",
                        "max abs <= 1e-5 x max |plain|"),
    "analytic_chords": ("cuda", "dexct_tpu_torch/csrc/analytic_chords.cu",
                        "dexct_tpu/system/analytic.py:81",
                        "max abs <= 1e-5 x max path"),
    "siddon_trace_3d": ("cuda", "dexct_tpu_torch/csrc/siddon_trace_3d.cu",
                        "dexct_tpu/ops/conebeam.py:1162",
                        "max abs <= 1e-4 cm"),
    "fdk_backproject": ("cuda", "dexct_tpu_torch/csrc/cone_backproject.cu",
                        "dexct_tpu/ops/conebeam.py:1879",
                        "max abs <= 1e-4 x max |plain|"),
    "helical_backproject": ("cuda",
                            "dexct_tpu_torch/csrc/cone_backproject.cu",
                            "dexct_tpu/ops/conebeam.py:413",
                            "max abs <= 1e-4 x max |plain|"),
    "flat_backproject": ("cuda", "dexct_tpu_torch/csrc/cone_backproject.cu",
                         "dexct_tpu/ops/flatpanel.py:100",
                         "max abs <= 1e-4 x max |plain|"),
    "katsevich_derivative": ("triton", "dexct_tpu_torch/ops/katsevich.py",
                             "dexct_tpu/ops/katsevich.py:352",
                             "max abs <= 1e-5 x max |plain|"),
    "katsevich_backproject": ("cuda",
                              "dexct_tpu_torch/csrc/cone_backproject.cu",
                              "dexct_tpu/ops/katsevich.py:205",
                              "max abs <= 1e-4 x max |plain|"),
    "trilinear_sample": ("cuda", "dexct_tpu_torch/csrc/trilinear_sample.cu",
                         "dexct_tpu/ops/conebeam.py:778",
                         "bitwise equal to the plain version (within max "
                         "abs <= 1e-5 x max |plain|); no allocation beyond "
                         "the output"),
    "siddon_trace_stack": ("cuda",
                           "dexct_tpu_torch/csrc/siddon_trace_stack.cu",
                           "dexct_tpu/ops/siddon_fast.py:827",
                           "max abs <= 1e-4 cm; bitwise equal to K1 on "
                           "every slice"),
    "project_3d": ("cuda", "dexct_tpu_torch/csrc/siddon_project_3d.cu",
                   "dexct_tpu/ops/conebeam.py:1028",
                   "max abs <= 1e-4 x max |plain|; on mu[labels] <= 1e-4 x "
                   "max of K10's paths . mu"),
    "backproject_3d": ("cuda", "dexct_tpu_torch/csrc/siddon_project_3d.cu",
                       "dexct_tpu/ops/conebeam.py:1028",
                       "max abs <= 1e-4 x max |plain| (the card's plain "
                       "version adds with atomic index_add_); bitwise equal "
                       "to the CPU's plain version on every 30th view; two "
                       "launches bitwise equal; <Ax, y> = <x, A^T y> to rel "
                       "1e-4"),
    "cone_transpose": ("cuda", "dexct_tpu_torch/csrc/siddon_project_3d.cu",
                       "dexct_tpu/ops/conebeam.py:1028",
                       "bitwise equal to the plain builder's table (runs, "
                       "slice offsets, every slot's ray and segment)"),
    "pi_backproject": ("cuda", "dexct_tpu_torch/csrc/pi_backproject.cu",
                       "dexct_tpu/ops/helical_pi.py:128",
                       "max abs <= 1e-4 x max |plain|"),
    "kb_sample_adjoint": ("cuda", "dexct_tpu_torch/csrc/kb_sample.cu",
                          "dexct_tpu/ops/fourier.py:258",
                          "max abs <= 1e-5 x max |plain| (the card's plain "
                          "version adds with atomic index_add_); bitwise "
                          "equal to the CPU's plain version; two launches "
                          "bitwise equal; <K7 F, g> = <F, K21 g> to rel "
                          "1e-5"),
    "resample_to_fan_adjoint": ("cuda",
                                "dexct_tpu_torch/csrc/gather_taps.cu",
                                "dexct_tpu/ops/fourier.py:397",
                                "max abs <= 1e-5 x max |plain|; <K8 r, y> = "
                                "<r, K22 y> to rel 1e-5; two launches "
                                "bitwise equal"),
    "dose_map": ("cuda", "dexct_tpu_torch/csrc/dose.cu",
                 "dexct_tpu/ops/dose.py:184",
                 "max abs <= 1e-4 x max |plain|; deposited rel 1e-4"),
    "dose_map_3d": ("cuda", "dexct_tpu_torch/csrc/dose.cu",
                    "dexct_tpu/ops/dose.py:629",
                    "max abs <= 1e-4 x max |plain|; deposited rel 1e-4"),
    "fan_backproject_var": ("cuda", "dexct_tpu_torch/csrc/fan_backproject.cu",
                            "dexct_tpu/ops/noisemap.py:70",
                            "max abs <= 1e-5 x max |plain|"),
    "single_scatter": ("cuda", "dexct_tpu_torch/csrc/scatter.cu",
                       "dexct_tpu/ops/scatter_physics.py:128",
                       "max abs <= 1e-4 x max |plain| (float32 sums over "
                       "vertices, energies and steps in another order); "
                       "repeats bitwise"),
    "single_scatter_conebeam": ("cuda", "dexct_tpu_torch/csrc/scatter.cu",
                                "dexct_tpu/ops/scatter_physics.py:1229",
                                "max abs <= 1e-4 x max |plain| (as K26); "
                                "repeats bitwise"),
    "table_counts": ("triton", "dexct_tpu_torch/ops/spectral.py",
                     "dexct_tpu/ops/spectral.py:67 (per_channel=True); "
                     "dexct_tpu/ops/heel.py:111", "max rel <= 1e-5"),
    "gauss_newton_grouped": ("cuda", "dexct_tpu_torch/csrc/gauss_newton.cu",
                             "dexct_tpu/ops/bowtie.py:215; "
                             "dexct_tpu/ops/heel.py:179",
                             "max |d| / max(|a|, 1) <= 1e-4; one group "
                             "bitwise equal to K3"),
    "fan_backproject_motion": ("cuda",
                               "dexct_tpu_torch/csrc/fan_backproject.cu",
                               "dexct_tpu/ops/motion.py:256",
                               "max abs <= 1e-5 x max |plain|; bitwise "
                               "equal to K4 at zero pose"),
    "gated_backproject": ("cuda", "dexct_tpu_torch/csrc/fan_backproject.cu",
                          "dexct_tpu/pipeline/gated.py:79",
                          "max abs <= 1e-5 x max |plain|; all-ones over "
                          "one turn = K4 within 1e-5 x max where every "
                          "view's fan covers the pixel"),
    "fdk_backproject_motion": ("cuda",
                               "dexct_tpu_torch/csrc/cone_backproject.cu",
                               "dexct_tpu/ops/motion.py:514",
                               "max abs <= 1e-4 x max |plain|"),
    "helical_backproject_motion": ("cuda",
                                   "dexct_tpu_torch/csrc/cone_backproject.cu",
                                   "dexct_tpu/ops/motion.py:831",
                                   "max abs <= 1e-4 x max |plain|"),
    "multibin_counts": ("triton", "dexct_tpu_torch/ops/spectral.py",
                        "dexct_tpu/ops/spectral.py:67 (i0 [E, M])",
                        "max rel <= 1e-5"),
    "gauss_newton_general": ("cuda", "dexct_tpu_torch/csrc/gauss_newton.cu",
                             "dexct_tpu/ops/matdecomp.py:333 (K in {3, 4}, "
                             "M >= K, newton, lm_damping, warm)",
                             "max |d| / max(|a|, 1) <= 1e-4 (K = 4: on 99 % "
                             "of pixels); at (2, 2) within 1e-4 of K3"),
    "afterglow_apply": ("cuda", "dexct_tpu_torch/csrc/afterglow.cu",
                        "dexct_tpu/ops/afterglow.py:60",
                        "max abs <= 1e-6 x max |plain| (bitwise reported); "
                        "apply then correct within 1e-5 x max of the "
                        "counts"),
    "afterglow_correct": ("cuda", "dexct_tpu_torch/csrc/afterglow.cu",
                          "dexct_tpu/ops/afterglow.py:92",
                          "max abs <= 1e-6 x max |plain| (bitwise "
                          "reported)"),
    "gather_vmem": ("cuda", "dexct_tpu_torch/csrc/gather_probe.cu",
                    "tools/bench_gather.py:101", "bitwise equal to tab[idx]"),
    "gather_take": ("cuda", "dexct_tpu_torch/csrc/gather_probe.cu",
                    "tools/bench_gather.py:116", "bitwise equal to tab[idx]"),
}
# the library paths of the helical study reconstructors and the exact 3-D
# iterative reconstruction, and the kernels each launches
HELICAL_WEIGHTING_KERNELS = ("siddon_trace_3d", "spectral_counts",
                             "gauss_newton", "helical_backproject")
CONE_PWLS_KERNELS = ("siddon_trace_3d", "fdk_backproject", "project_3d",
                     "backproject_3d", "cone_transpose")
HELICAL_PI_KERNELS = ("siddon_trace_3d", "rebin_to_parallel",
                      "pi_backproject")
# the library paths of the 2-D iterative and one-step reconstructions and
# of the dose maps, and the kernels each launches
ITERATIVE_2D_KERNELS = ("siddon_trace", "fan_backproject", "kb_sample",
                        "resample_to_fan", "kb_sample_adjoint",
                        "resample_to_fan_adjoint")
ONESTEP_KERNELS = ("kb_sample", "resample_to_fan", "kb_sample_adjoint",
                   "resample_to_fan_adjoint")
DOSE_KERNELS = ("siddon_trace", "siddon_trace_3d", "dose_map", "dose_map_3d")
# the library paths of protocol planning, noise and scatter prediction, and
# the kernels each launches
NOISE_MAP_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
                     "fan_backproject", "fan_backproject_var")
# the library paths of the scanner-realism chain, and the kernels each
# launches: the bowtie under the artifact chain (K28 counts, K29 grouped
# solve), tube-current modulation (K2, K3) and the anode heel on the cone
# config (K28 per-row counts, K29 over the rows)
REALISTIC_KERNELS = ("siddon_trace", "table_counts", "gauss_newton_grouped",
                     "fan_backproject", "afterglow_apply", "afterglow_correct")
TCM_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
               "fan_backproject")
HEEL_KERNELS = ("siddon_trace_3d", "table_counts", "gauss_newton_grouped",
                "fdk_backproject")
# the library paths of patient motion and gated reconstruction, and the
# kernels each launches: the motion-compensated FBP (K30) with the joint
# estimator and the motion-compensated one-step fit on the Fourier
# projector's Radon transform (K7, K21 in the backward pass); the gated
# series (K31); the motion-compensated cone FDK (K32) and helical gFDK (K33)
MOTION_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
                  "fan_backproject_motion", "kb_sample", "kb_sample_adjoint")
GATED_KERNELS = ("siddon_trace", "gated_backproject")
# the spectral photon-counting paths and the other DE acquisition modes,
# and the kernels each launches: the packed 2-D PCD step (K1, the bins'
# counts K34, the multi-bin decomposition K35, rebin K5 and parallel BP
# K6) and the K-edge scan (K1, K34, K35, fan BP K4); the cone PCD paths
# (K10, K34, K35, FDK K11, helical gFDK K12); kV switching, dual source and
# dual layer through the composed DE path (K1-K4)
SPECTRAL_KERNELS = ("siddon_trace", "multibin_counts", "gauss_newton_general",
                    "rebin_to_parallel", "parallel_backproject",
                    "fan_backproject")
SPECTRAL_CONE_KERNELS = ("siddon_trace_3d", "multibin_counts",
                         "gauss_newton_general", "fdk_backproject",
                         "helical_backproject")
ACQUISITION_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
                       "fan_backproject")
# the realistic path's afterglow stage (tests/test_realism_chain.py:36-48):
# trap fractions and time constants [ms] at 1 ms per view, warm start
AFTERGLOW_FRACTIONS = (0.05, 0.02)
AFTERGLOW_TAU_MS = (2.0, 20.0)
# the gather-rate probe (tools/bench_gather.py): its table, its two index
# counts (2^20 the Pallas probes', 2^24 the other probes'), the 512^2
# label table
GATHER_TABLE = 800
GATHER_N_LOG2 = (20, 24)
GATHER_KERNELS = ("gather_vmem", "gather_take")
# the sweep path: the JAX package's dose study (tools/dose_study_full.py:
# 51-96: the 512^2 pelvis over 50 cm, 1000 views x 800 channels,
# detunedMV 9 mGy with 80 kV 1 mGy, parallel recon 512 x 1600, 12
# iterations, compound noise, two realizations) read through the port's
# analysis against the committed readings (results/dose_study_full.json,
# pelvis/MV-80kV), and BASELINE config 5's width
# (tools/bench_highres_only.py:37-48: the 1024^2 pelvis at 0.05 cm, 1440
# views x 1600 channels, 1024^2 images, siddon/fan, 10 iterations)
DOSE_STUDY_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)
DOSE_STUDY_SEEDS = (17, 18)
DOSE_STUDY_ROIS = ((243, 261, 24, 24), (243, 324, 24, 24))  # signal, bg
DOSE_EXPONENT_TOL = 0.06
VMI70_CONTRAST_TOL_HU = 3.0
HIGHRES_RAMPS = (0.3, 0.8, 1.0)
SWEEP_PARALLEL_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
                          "rebin_to_parallel", "parallel_backproject")
SWEEP_FAN_KERNELS = ("siddon_trace", "spectral_counts", "gauss_newton",
                     "fan_backproject")
# a 1 cm ROI of ICRU tissue (labels 2) in the pelvis, (x, y) cm: its
# density in the tissue basis
TISSUE_XY, TISSUE_DENSITY, TISSUE_TOL = (-0.3, -3.7), 1.06, 0.05
MOTION_3D_KERNELS = ("siddon_trace_3d", "spectral_counts", "gauss_newton",
                     "fdk_backproject_motion", "helical_backproject_motion")
# the motion path's breathing track (tests/test_motion.py:96-110)
MOTION_TRACK = dict(amplitude_cm=0.8, cycles=1.5, direction=(1.0, 0.4))
# the JAX package's ratio of the uncorrected to the motion-compensated rms
# error against the static image, the least over the two log and two basis
# images, on the same scene at half resolution (motion_reference in
# tests/test_torch_motion.py: 3.8842, 3.8881, 3.7959, 3.8686); the card's
# least ratio must reach it
MOTION_RATIO_REF = 3.7959
# the JAX package's track errors over the rms amplitude on the same scene
# at half resolution (motion_reference: centroid 3.3891, joint 3.0082), and
# the bands the card's must lie in: the centroid fit is host float64
# (3.3911 in three runs on an H100), the joint one float32 Adam at twice
# the sampling (2.9664-2.9667 in the same runs)
MOTION_TRACK_REF = ((3.3891, 0.01), (3.0082, 0.1))
# the gated path (tests/test_gated.py:98-134 at the reference fan): the
# thorax at 70 keV, GATED_TURNS turns of the reference protocol's views,
# AP breathing of GATED_AMP_CM with GATED_CYCLES cycles over the scan,
# GATED_GATES gates of width 0.3; the gate at the pose extreme must beat
# the ungated average on the lungs by GATED_FACTOR
GATED_TURNS, GATED_CYCLES, GATED_AMP_CM, GATED_KEV = 4, 5, 0.8, 70.0
GATED_GATES, GATED_FACTOR = 4, 0.6
# the motion_3d path's axial drifts: 0.5 cm on the cone config, 1.6 cm on
# the helical one (dexct_tpu/ops/motion.py:90-92)
CONE_DZ_CM, HELICAL_DZ_CM = 0.5, 1.6
# the JAX package's readings of the helical motion_3d scene at half its
# in-plane resolution (_helical_reference in tests/test_torch_motion.py):
# each image's ratio of the uncorrected to the compensated rms error (log
# detunedMV, log 80 kV, tissue, bone; the card's must reach each and
# exceed 1), and the compensated 80 kV air ROI HU (-1129.19: at the
# track's peak the object moves 3.8 cm per turn against the 3 cm table
# feed, so the object-frame helix reverses; the card's within AIR_TOL_HU
# of it)
HELICAL_RATIO_REF = (0.9104, 1.1938, 1.1039, 2.0435)
HELICAL_AIR_REF, AIR_TOL_HU = -1129.19, 50.0
# K32/K33's operations (exp, atan2, division, square root count one): per
# (disc pixel, view) the in-plane geometry, the pose 8, ell, vt, h^2 and
# 1 / h 13, the channel and its fan test 7, the channel tap 6 and 1 / h^2
# 1; per (pixel, slice, view) row the row position and its test 6 and the
# coverage count 1; per row with taps the row tap 7 (and 7 per image)
MOTION_PLANE_OPS, MOTION_ROW_OPS, MOTION_TAP_OPS = 35, 7, 7
# K11's, K12's and K13's in-plane geometry per (disc pixel, view): K32's
# without the pose (ell, vt, h^2 and 1 / h, the channel, its fan test and
# tap, 1 / h^2; K13's u, channel and 1 / ell^2 alike); their rows and taps
# as K32's
PLANE_OPS = MOTION_PLANE_OPS - 8
# the JAX study's bowtie (tools/protocol3d_study.py:120) and heel
# (tools/smoke_r3s5.py:81)
BOWTIE_RADIUS_CM = 15.0
HEEL_D0_CM = 10e-4
SCATTER_KERNELS = ("siddon_trace", "spectral_counts", "siddon_trace_3d",
                   "single_scatter", "single_scatter_conebeam")
# the noise-map path's ensemble, and its VMI energies [keV]: the
# reference protocol pairs a megavoltage beam with 80 kV, whose VMI noise
# minimum lies where the tissue and bone mass attenuations cross, above a
# kV/kV pair's 40-140 keV bracket (over which the curve falls
# monotonically); VMI_MIN_KEV is the JAX package's minimum on this
# protocol at half its resolution (vmi_reference in
# tests/test_torch_noisemap.py), within 0.9 % of its value over +-20 keV,
# so the card's minimum must lie within VMI_MIN_TOL_KEV of it
NOISE_REALISATIONS = 64
VMI_KEV = tuple(range(40, 301, 5))
VMI_MONOTONE_KEV = 140
VMI_MIN_KEV = 175.0
VMI_MIN_TOL_KEV = 15.0
# K26 and K27 at the JAX package's own study settings
# (tools/protocol3d_study.py:234-236, tools/smoke_r3s3.py:95-109): the fan
# at the estimator's defaults (4096 vertices of the 256^2 pelvis, 12
# energies, s_in 128, s_out 64) on every 50th view and channel_sub 8 (101
# channels); the cone config at coarse 8 (32 x 32 x 4 vertices), 8
# energies, every 8th channel and 4th row (33 x 5 elements) on every 45th
# view; the plain versions on two of those views
FAN_SCATTER = dict(coarse=4, n_energy=12, channel_sub=8)
FAN_SCATTER_EVERY = 50
CONE_SCATTER = dict(coarse=8, n_energy=8, channel_sub=8, row_sub=4)
CONE_SCATTER_EVERY = 45
PLAIN_VIEWS = [0, 5]
# the in-object single-scatter SPR (no anti-scatter grid) of each scene:
# the JAX package's reading at half the in-plane resolution (spr_reference
# in tests/test_torch_scatter_physics.py), within a factor SPR_FACTOR (the
# mean weights the rays a pelvis transmits < 1 % of; their medians are
# 0.023, 0.22 and 0.47)
SPR_REF = {"fan detunedMV": 0.021726, "fan 80kV": 0.72856,
           "cone 80kV": 1.2636}
SPR_FACTOR = 1.5
# the 2-D iterative path's Poisson scan: unattenuated counts per ray
ITER_N0 = 1.0e5
# the centre of the 2-D pelvis's bladder (water) in cm: rows 128-144 and
# columns 118-138 of its 256^2 labels at 0.2 cm are water
BLADDER_XY = (0.0, 1.7)
# K12's float32 operations per (pixel, slice, view) on the detector within
# its slice's window beyond PLANE_OPS per (disc pixel, view): each gFDK
# window's own (cosine, sine and division count as one), besides the row's
# MOTION_ROW_OPS; MOTION_TAP_OPS + 7 K more where the weight is nonzero
# inside the fan (the taps of K stacks)
WEIGHT_OPS = {"full": 0, "feather": 6, "td": 16, "cosz": 8, "short": 16,
              "pair": 30}
# what the JAX package's helical_fdk_reconstruct reads on the helical
# config's log sinograms, per weighting, at the central slice (z = 0):
# (air ROI at (0, -18) cm, body ROI at (0, 0) cm) in HU, detunedMV and 80kV
# (tests/test_torch_cone.py's witness on chip_smoke.py --witness's output);
# the fused step in that weighting must read them within REF_TOL_HU
WEIGHTING_REF_HU = {
    "pair": ((-1058.78, -1066.11), (-139.89, -123.52)),
    "td": ((-1300.32, -1335.65), (-111.43, -87.60)),
    "short": ((-987.56, -987.40), (-139.53, -122.74)),
}
REF_TOL_HU = 2.0
# the monoenergetic scans of the iterative and PI paths: 60 keV, and the
# PWLS scan's unattenuated counts per ray (at 2e4 the lateral rays through
# the 42 cm wide pelvis keep ~3 counts, and the clamped logs bias FDK 16 %
# low in the bladder; 1e5 keeps ~15)
MONO_KEV = 60.0
PWLS_N0 = 1.0e5
# the CLI paths: flags, whether the params file is a 3-D config, and the
# kernels each launches
PATHS = {
    "default": ([], None, ("kb_sample", "resample_to_fan", "spectral_counts",
                           "gauss_newton", "rebin_to_parallel",
                           "parallel_backproject")),
    "exact": (["--projector", "siddon", "--recon", "fan"], None,
              ("siddon_trace", "spectral_counts", "gauss_newton",
               "fan_backproject")),
    "cone": ([], "cone", ("siddon_trace_3d", "spectral_counts",
                          "gauss_newton", "fdk_backproject")),
    "helical": ([], "helical", ("siddon_trace_3d", "spectral_counts",
                                "gauss_newton", "helical_backproject")),
    "flat": ([], "flat", ("siddon_trace_3d", "spectral_counts",
                          "gauss_newton", "flat_backproject")),
    "tilted": ([], "tilted", ("siddon_trace_3d", "spectral_counts",
                              "gauss_newton", "fdk_backproject",
                              "trilinear_sample")),
    "zffs": ([], "zffs", ("siddon_trace_3d", "spectral_counts",
                          "gauss_newton", "helical_backproject")),
    "katsevich": (["--recon3d", "katsevich"], "helical",
                  ("siddon_trace_3d", "spectral_counts", "gauss_newton",
                   "katsevich_derivative", "katsevich_backproject")),
    "ffs": ([], "ffs", ("siddon_trace", "spectral_counts", "gauss_newton",
                        "rebin_to_parallel", "parallel_backproject")),
    "parallel_beam": ([], "parallel_beam",
                      ("siddon_trace", "spectral_counts", "gauss_newton",
                       "parallel_backproject")),
    "bhc_denoise": (["--bhc", "--denoise"], None,
                    ("kb_sample", "resample_to_fan", "spectral_counts",
                     "gauss_newton", "rebin_to_parallel",
                     "parallel_backproject", "fan_backproject")),
}
# the 2-D configurations beside input/params.txt: its keys with these
# changes (both run the composed path, as the JAX runner sends them)
CONFIGS_2D = {"ffs": {"flying_focal_spot": "inplane"},
              "parallel_beam": {"scanner_geometry": "parallel_beam"}}
# the JAX package's parallel-beam images come out turned by 90 degrees
# against the phantom (its rays' lateral axis at view b is (-sin b, cos b),
# its backprojector's (cos b, sin b)); the port writes the same files, so
# the air below the body lies at (-20, 0) cm there
AIR_XY = {"parallel_beam": (-20.0, 0.0)}
# the extra files of the --bhc --denoise path: per acquisition two
# denoised images, per spectrum four BHC images
BHC_FILES = [f"recon_{k}BHC_{u}" for k in ("water", "bone")
             for u in ("raw", "HU")]
DENOISED_FILES = ["recon_denoised_raw", "recon_denoised_HU"]
ZSTACK_KERNELS = ("siddon_trace_stack", "spectral_counts", "gauss_newton",
                  "rebin_to_parallel", "parallel_backproject")
# the JAX package's own z-stack workload (tools/bench_zstack.py:36-46):
# 1000 views x 800 channels through 8 slices of the 512^2 pelvis at 0.1 cm,
# slice k rolled by 7k columns; 512^2 images over 50 cm
ZSTACK_NZ = 8
# the paths that run the stateless 3-D branch (simulate_cone_dect)
STATELESS = ("flat", "tilted", "zffs", "katsevich")
# the paths that scan the cone path's phantom and reconstruct its central
# slice at the same z: their body ROI (water) must read the cone path's HU
# within BODY_TOL_HU (water against the adipose around it is ~100 HU)
SAME_SLICE_AS_CONE = ("flat", "tilted", "zffs")
BODY_TOL_HU = 50.0
ANALYTIC_KERNELS = ("analytic_chords", "spectral_counts", "gauss_newton",
                    "rebin_to_parallel", "parallel_backproject")
# the repo's own cone configurations (tools/bench_r3c.py:60-69,
# tools/bench_helical.py:62-66) as params-file entries, and the cone one
# with a flat panel, a 15-degree gantry tilt and a z flying focal spot
CONE_CONFIGS = {
    "cone": dict(scanner_geometry="cone_beam", N_projections=360,
                 phantom_nz=32),
    "helical": dict(scanner_geometry="helical_cone_beam", N_projections=720,
                    rotation_angle_total=4.0 * 3.141592653589793, pitch=3.0,
                    phantom_nz=48),
    "flat": dict(scanner_geometry="flat_panel_cone_beam", N_projections=360,
                 phantom_nz=32),
    "tilted": dict(scanner_geometry="tilted_cone_beam", gantry_tilt_rad=0.2618,
                   N_projections=360, phantom_nz=32),
    "zffs": dict(scanner_geometry="cone_beam", flying_focal_spot="z",
                 N_projections=360, phantom_nz=32),
}
# the keys of a cone configuration that select its geometry's variant
VARIANT_KEYS = ("scanner_geometry", "gantry_tilt_rad", "flying_focal_spot")
# the spectral paths: the reference protocol as a photon-counting scan
# (the shipped Si PCD response, the 140 kV spectrum at 10 mGy)
PCD_PARAMS = {"detector_mode": "pcd",
              "detector_filename": "input/detector/eta_pcd_Si_30mm.bin"}
PCD_DOSE_MGY = 10.0
PCD_THRESHOLDS = (20.0, 34.0, 50.0, 70.0)
# the packed path's pulse pileup: resolving time set so that air rays
# count at rho = 0.1 (the JAX tests' 1e-5 is for ~2e4 counts per ray; at
# this protocol's ~1e10 it would paralyse every ray)
PCD_PILEUP_RHO = 0.1
# the K-edge case (tests/test_spectralct.py:432-474): six bins straddling
# the iodine (33.2 keV) and gadolinium (50.2 keV) K-edges, basis water,
# bone, iodine, gadolinium, and rods of 10 mg/mL contrast (the JAX test's
# solutions) at (x, y) cm; in two scenes at the reference protocol's width:
# the JAX test's 19.2 cm water cylinder (256^2 at 0.075 cm, 1.5 cm rods
# 3 cm off its centre, images 256^2 over 19.2 cm) and the pelvis (1 cm
# rods in its muscle, images 512^2 over 50 cm)
KEDGE_THRESHOLDS = (20.0, 34.0, 45.0, 52.0, 65.0, 85.0)
KEDGE_AGENTS = (("iodine 10mg/mL", 1.008, "H(11.1)O(87.9)I(1.0)"),
                ("gado 10mg/mL", 1.008, "H(11.1)O(87.9)Gd(1.0)"))
KEDGE_SCENES = {"cylinder": (((0.0, 3.0), (0.0, -3.0)), 1.5),
                "pelvis": (((-6.7, -5.1), (6.9, -5.1)), 1.0)}
KEDGE_CYLINDER = dict(N=256, dx=0.075)  # water_cylinder_phantom's
KEDGE_CYLINDER_IMAGE = (256, 19.2)  # matrix, FOV [cm]
KEDGE_AGENT = 0.010  # g/cm^3 of the agent in its rod
KEDGE_TOL = 0.002  # the JAX test's bar on each rod's agent and cross-talk
# what the JAX package reads on each K-edge scene at half resolution (the
# phantom's every other label at twice the voxel size, 500 views x 400
# channels, images at half the matrix; kedge_reference in
# tests/test_torch_spectralct.py): per rod, the (iodine, gadolinium) basis
# densities of its 1 cm ROI.  On the cylinder the card must read each within
# KEDGE_TOL of them; on the pelvis the readings are printed beside them: its
# lateral rays starve the two lowest bins (transmission ~1e-8 of air at
# 20-34 keV), the K = 4 solve there is chaotic, and the JAX program and the
# port's plain version read its rods up to 0.0075 g/cm^3 apart at half
# resolution
KEDGE_REF = {"cylinder": {"iodine": (0.01009, -0.00001),
                          "gadolinium": (-0.00001, 0.01009)},
             "pelvis": {"iodine": (0.00936, 0.00121),
                        "gadolinium": (0.00826, 0.01043)}}
# K35's rows per energy node and operations (the gn_work style; exp and
# division count one): per (pixel, iteration, node) the exponent 2 K, one
# exp, the moment sums 2 M (1 + K) and with "newton" 2 M T more; per
# (pixel, iteration) the step: 2 M (K + T) for dF and H, 8 M for the
# residuals, and the closed-form solve (2x2 20, 3x3 50, 4x4 160)
SOLVE_OPS = {2: 20, 3: 50, 4: 160}


def kedge_labels(labels, dx, dy, first_label, scene):
    """``labels`` [..., Ny, Nx] (a grid centred on the isocenter, y along
    the rows) with the rods of the K-edge ``scene`` set to ``first_label``
    (iodine) and the label after it (gadolinium)."""
    import numpy as np

    centres, radius = KEDGE_SCENES[scene]
    ny, nx = labels.shape[-2:]
    y = (np.arange(ny) + 0.5 - ny / 2.0) * dy
    x = (np.arange(nx) + 0.5 - nx / 2.0) * dx
    out = np.array(labels, copy=True)
    for i, (cx, cy) in enumerate(centres):
        out[..., np.hypot(x[None, :] - cx, y[:, None] - cy) <= radius] = \
            first_label + i
    return out


def kedge_phantom(phantom, scene, material_table, material):
    """``phantom`` with the K-edge ``scene``'s rods as two labels after its
    own, made with the given MaterialTable and Material classes (either
    package's)."""
    import dataclasses

    mats = list(phantom.materials.materials)
    return dataclasses.replace(
        phantom, labels=kedge_labels(phantom.labels, phantom.dx, phantom.dy,
                                     len(mats), scene),
        materials=material_table(mats + [material(*m)
                                         for m in KEDGE_AGENTS]))


def kedge_reading(basis_recons, fov, scene):
    """Each rod's (iodine, gadolinium) basis densities [g/cm^3] in the
    K-edge ``scene``: the means of its 1 cm ROI in basis images 2 and 3 of
    [4, N, N] (a tensor or an array)."""
    import numpy as np

    imgs = np.asarray(basis_recons.cpu() if hasattr(basis_recons, "cpu")
                      else basis_recons)
    return {rod: tuple(roi_mean(imgs[k][None], cx, cy, 0, fov)
                       for k in (2, 3))
            for rod, (cx, cy) in zip(("iodine", "gadolinium"),
                                     KEDGE_SCENES[scene][0])}


# one H100 SXM (NVIDIA's data sheet): HBM3 rate and float32 peak outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=20, reps=5):
    """Device time of one call of ``fn`` in ms, without the host's time:
    ``calls`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events (after a warm-up call on a side stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def compare(kernel_fn, plain_fn, reps, plain_reps=None):
    """Kernel and plain outputs and their times, measured in turns (plain,
    kernel, kernel, plain) within this call; the plain version over
    ``plain_reps`` calls when given (for plain loops far slower than the
    kernel), else ``reps``."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    plain_reps = reps if plain_reps is None else plain_reps
    tp = [time_ms(plain_fn, plain_reps)]
    tk = [time_ms(kernel_fn, reps), time_ms(kernel_fn, reps)]
    tp.append(time_ms(plain_fn, plain_reps))
    return got, want, sum(tk) / 2, sum(tp) / 2


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """The least time [ms] the card could take: the larger of the bytes
    over the memory rate and the float32 operations over the peak rate."""
    t_bytes = float(n_bytes) / PEAK_BYTES_S * 1e3
    t_ops = float(n_ops) / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(records, name, err, ms, plain_ms, ok, work, library_ms=None,
           extra="", record=True):
    """Print and record one kernel's comparison; ``work`` is (bytes read
    and written once, float32 operations) of the call.  ``record=False``
    prints and checks a further case of a recorded kernel."""
    bound_ms, bound_by = bound(*work)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"  {name:20s} max_abs_err={err:.6g}{extra}  kernel={ms:.4f} ms"
          f"  plain={plain_ms:.4f} ms  bound={bound_ms:.4f} ms ({bound_by})"
          f"  library={lib}  [{KERNELS[name][3]}]")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    if not record:
        return
    route, src, replaces, _ = KERNELS[name]
    records[name] = {"name": name, "route": route, "source": src,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}


def max_err(got, want):
    """Max abs difference and max |want|."""
    return float((got - want).abs().max()), float(want.abs().max())


def sparse_taps(rows, cols, vals, shape):
    """A CSR matrix of (row, col, value) taps; repeated taps add."""
    import torch

    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def walk_steps(paths, dirs, cells):
    """Traversal steps of a Siddon walk on this run's rays: each ray's
    in-grid chord (its summed paths) times the plane crossings per cm
    along each axis, plus the entry cell."""
    chord = paths.reshape(-1, paths.shape[-1]).sum(-1)
    d = dirs.reshape(-1, dirs.shape[-1]).abs()
    per_cm = sum(d[:, i] / c for i, c in enumerate(cells))
    return float((chord * per_cm).sum()) + chord.numel()


def kernel_phase(arrays, meta, records):
    """Phase 3, exact path: K1-K4 against their plain versions at the
    reference protocol's shapes."""
    import torch

    from dexct_tpu_torch.ops import fbp_fast, matdecomp, siddon, spectral
    from dexct_tpu_torch.ops.fbp import filter_views

    a = arrays

    # K1: 8e5 exact rays through the 256^2 pelvis
    args = (a["labels"], a["src"], a["dirs"], meta.dx, meta.dy)
    kw = dict(n_materials=meta.n_materials)
    paths, want, ms, pms = compare(
        lambda: siddon.trace_paths(*args, **kw),
        lambda: siddon.trace_paths_plain(*args, **kw), reps=3)
    err = float((paths - want).abs().max())
    steps = walk_steps(paths, a["dirs"], (meta.dx, meta.dy))
    n_rays = paths.numel() // meta.n_materials
    report(records, "siddon_trace", err, ms, pms, err <= 1e-4,
           (nbytes(a["labels"], a["src"], a["dirs"], paths),
            6 * steps + 40 * n_rays))

    # K2: both spectra, counts as the main path asks for them; the
    # optional second-moment table is checked too (not timed)
    counts, errs, rels, ms_sum, pms_sum = [], [], [], 0.0, 0.0
    k2_bytes = k2_ops = 0
    for s in ("1", "2"):
        mu, i0, i2 = a["mu_t" + s], a["i0_" + s], a["i2_" + s]
        c, wc, ms, pms = compare(
            lambda: spectral.counts_from_paths(paths, mu, i0),
            lambda: spectral.counts_from_paths_plain(paths, mu, i0), reps=5)
        _, v = spectral.counts_from_paths(paths, mu, i0, i2)
        wv = spectral.counts_from_paths_plain(paths, mu, i2)
        for x, y in ((c, wc), (v, wv)):
            errs.append(float((x - y).abs().max()))
            rel = (x - y).abs() / y.abs().clamp_min(1e-30)
            rels.append(float(rel.max()))
        ms_sum += ms
        pms_sum += pms
        counts.append(c)
        k2_bytes += nbytes(paths, mu, i0, c)
        k2_ops += c.numel() * mu.shape[1] * (2 * meta.n_materials + 3)
    report(records, "spectral_counts", max(errs), ms_sum, pms_sum,
           max(rels) <= 1e-5, (k2_bytes, k2_ops),
           extra=f" (max rel {max(rels):.3g})")

    # K3: all 8e5 pixels, 50 iterations
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    gkw = dict(n_iters=meta.n_iters, pixel_block=meta.pixel_block,
               warm_nodes=meta.gn_warm_nodes)
    ab, want, ms, pms = compare(
        lambda: matdecomp.gauss_newton_solve(flat, a["dec_i0"], a["dec_mus"],
                                             **gkw),
        lambda: matdecomp.gauss_newton_solve_plain(flat, a["dec_i0"],
                                                   a["dec_mus"], **gkw),
        reps=2)
    err = float((ab - want).abs().max())
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    report(records, "gauss_newton", err, ms, pms, rel <= 1e-4,
           gn_work(flat, ab, a["dec_mus"].shape[1], meta),
           extra=f" (rel {rel:.3g})")

    # K4: 4 x 512^2 from the filtered 4 x 1000 x 800 sinogram stack
    log = [spectral.log_sinogram(c, air) for c, air in
           zip(counts, (meta.air1, meta.air2))]
    sinos = torch.stack([log[0], log[1], ab[:, 0].reshape(log[0].shape),
                         ab[:, 1].reshape(log[0].shape)])
    packed = fbp_fast.pack_filtered(filter_views(
        sinos, a["cos_w"], a["filt_H"], meta.fft_len, meta.dgamma))
    bargs = (packed, 4, a["betas"], meta.sid, meta.dgamma, sinos.shape[-1],
             meta.n_matrix, meta.fov, meta.dbeta)
    img, want, ms, pms = compare(
        lambda: fbp_fast.fan_backproject_multi(*bargs),
        lambda: fbp_fast.fan_backproject_multi_plain(*bargs), reps=3)
    err = float((img - want).abs().max())
    V = a["betas"].shape[0]
    report(records, "fan_backproject", err, ms, pms, err <= 1e-4,
           (nbytes(packed, img) + 8 * V,
            meta.n_matrix ** 2 * V * (25 + 4 * 4)))


def gn_work(flat, ab, e_full, meta, polish=4, warm_nodes=32, n_tables=1):
    """Bytes and operations of one GN solve: per pixel and iteration, 17
    operations per energy node (the exponent, exp, six moment sums) and
    ~40 for the 2 x 2 step; the warm phase on the ~warm_nodes-node table
    when the union grid has more than twice as many bins; ``n_tables``
    fluence groups' tables read once each."""
    n_pix = flat.shape[1]
    e_warm = e_full
    if e_full > 2 * warm_nodes and meta.n_iters > polish:
        seg = -(-e_full // warm_nodes)
        e_warm = -(-e_full // seg)
    n_pol = min(polish, meta.n_iters)
    per_pix = ((meta.n_iters - n_pol) * (17 * e_warm + 40)
               + n_pol * (17 * e_full + 40))
    return (nbytes(flat, ab) + 64 * (e_full + e_warm) * n_tables,
            n_pix * per_pix)


def default_kernel_phase(arrays, meta, records):
    """Phase 3, default path: K7, K8, K5 and K6 against their plain
    versions at the reference protocol's shapes, and K2 and K3 again on
    the Fourier paths (which ring slightly negative at edges)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import fbp_fast, fourier, matdecomp, spectral
    from dexct_tpu_torch.ops.fbp import filter_views
    from dexct_tpu_torch.pipeline.fused import dect_step

    a = arrays
    n_mat, n_theta, nt, grid, n_img, scale = meta.fp_meta

    # K7: the 6 material spectra (G = 512) along 1024 x 257 radial samples
    F = fourier._spectrum(fourier._onehot_images(a["labels"], n_mat),
                          a["fp_deapod"], grid, n_img)
    sargs = (F, a["fp_slice_idx"], a["fp_slice_w"], a["fp_phase_cos"],
             a["fp_phase_sin"])
    spec, want, ms, pms = compare(lambda: fourier.kb_sample(*sargs),
                                  lambda: fourier.kb_sample_plain(*sargs),
                                  reps=5)
    err, big = max_err(spec, want)
    # the library yardstick: the 16 taps of every sample, times its phase,
    # as one complex64 CSR matrix applied to the flattened spectra
    G = F.shape[-1]
    S = a["fp_slice_idx"].numel()
    base = a["fp_slice_idx"].reshape(-1).to(torch.int64)
    offs = torch.arange(4, device=base.device)
    cols = (torch.remainder(base[:, None, None] // G + offs[None, None, :],
                            G) * G
            + torch.remainder(base[:, None, None] % G + offs[None, :, None],
                              G)).reshape(-1)
    phase = torch.complex(a["fp_phase_cos"].reshape(-1),
                          a["fp_phase_sin"].reshape(-1))
    vals = a["fp_slice_w"].reshape(S, 16).to(torch.complex64) * phase[:, None]
    W = sparse_taps(torch.arange(S, device=base.device).repeat_interleave(16),
                    cols, vals.reshape(-1), (S, G * G))
    dense = F.reshape(n_mat, -1).T.contiguous()
    lib_err = float((torch.sparse.mm(W, dense).T.reshape(spec.shape)
                     - want).abs().max())
    report(records, "kb_sample", err, ms, pms, err <= 1e-5 * big,
           (nbytes(*sargs, spec), spec.numel() * 70),
           library_ms=time_ms(lambda: torch.sparse.mm(W, dense), 5),
           extra=f" (max |plain| {big:.6g}; complex CSR library err "
                 f"{lib_err:.3g})")
    del W, dense, cols, vals

    # K8: 8e5 fan rays from the 6 x 1024 x 1024 Radon transforms; the
    # library yardstick is the same taps as one CSR product
    radon = torch.fft.irfft(spec, n=nt, dim=-1) * scale
    V, C4 = a["fp_fan_idx"].shape
    rargs = (radon, a["fp_fan_idx"], a["fp_fan_w"], (V, C4 // 4, n_mat))
    paths, want, ms, pms = compare(
        lambda: fourier.resample_to_fan(*rargs),
        lambda: fourier.resample_to_fan_plain(*rargs), reps=5)
    err, big = max_err(paths, want)
    table = radon.reshape(n_mat, -1)
    idx = a["fp_fan_idx"].reshape(-1, 4).to(torch.int64)
    W = sparse_taps(torch.arange(idx.shape[0], device=idx.device)
                    .repeat_interleave(4), idx.reshape(-1),
                    a["fp_fan_w"].reshape(-1), (idx.shape[0], table.shape[1]))
    dense = table.T.contiguous()
    lib_err = float((torch.sparse.mm(W, dense).reshape(paths.shape)
                     - want).abs().max())
    report(records, "resample_to_fan", err, ms, pms, err <= 1e-5 * big,
           (nbytes(radon, a["fp_fan_idx"], a["fp_fan_w"], paths),
            paths.numel() * 8),
           library_ms=time_ms(lambda: torch.sparse.mm(W, dense), 5),
           extra=f" (max |plain| {big:.6g} cm; library err {lib_err:.3g})")
    del W, dense
    print(f"  Fourier paths: min {float(paths.min()):.6g} cm, "
          f"{int((paths < 0).sum())} of {paths.numel()} negative")

    # K2 and K3 on the Fourier paths
    counts = []
    for s in ("1", "2"):
        c = spectral.counts_from_paths(paths, a["mu_t" + s], a["i0_" + s])
        wc = spectral.counts_from_paths_plain(paths, a["mu_t" + s],
                                              a["i0_" + s])
        rel = float(((c - wc).abs() / wc.abs().clamp_min(1e-30)).max())
        print(f"  spectral_counts on Fourier paths {s}: max rel {rel:.3g} "
              f"[max rel <= 1e-5]")
        if rel > 1e-5:
            fail("spectral_counts disagrees with its plain version on the "
                 "Fourier paths")
        counts.append(c)
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    gkw = dict(n_iters=meta.n_iters, pixel_block=meta.pixel_block,
               warm_nodes=meta.gn_warm_nodes)
    ab = matdecomp.gauss_newton_solve(flat, a["dec_i0"], a["dec_mus"], **gkw)
    want = matdecomp.gauss_newton_solve_plain(flat, a["dec_i0"],
                                              a["dec_mus"], **gkw)
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    print(f"  gauss_newton on Fourier counts: rel {rel:.3g} "
          f"[max |d| / max(|a|, 1) <= 1e-4]")
    if not (rel <= 1e-4 and bool(torch.isfinite(ab).all())):
        fail("gauss_newton disagrees with its plain version on the "
             "Fourier counts")

    # K5 and K6 on the default path's 4 x 1000 x 800 sinogram stack
    out = dect_step(a, meta)
    sinos = torch.stack([out["sino_log"][0], out["sino_log"][1],
                         out["mat_sinos"][0], out["mat_sinos"][1]])
    n_th, pnt, t0, dt, par_m = meta.par_meta
    rargs = (sinos, a["rb_idx"], a["rb_w"], pnt)
    par, want, ms, pms = compare(
        lambda: fbp_fast.rebin_to_parallel(*rargs),
        lambda: fbp_fast.rebin_to_parallel_plain(*rargs), reps=5)
    err, big = max_err(par, want)
    K, taps = sinos.shape[0], 8
    vc = sinos[0].numel()
    first = a["rb_idx"].reshape(-1, taps)[:, 0::2].to(torch.int64)
    cols = torch.stack([first, (first + 1) % vc], -1).reshape(-1)
    n_bins = first.shape[0]
    W = sparse_taps(torch.arange(n_bins, device=cols.device)
                    .repeat_interleave(taps), cols, a["rb_w"].reshape(-1),
                    (n_bins, vc))
    dense = sinos.reshape(K, -1).T.contiguous()
    lib_err = float((torch.sparse.mm(W, dense).T.reshape(par.shape)
                     - want).abs().max())
    report(records, "rebin_to_parallel", err, ms, pms, err <= 1e-5 * big,
           (nbytes(sinos, a["rb_idx"], a["rb_w"], par),
            n_bins * taps * 2 * K),
           library_ms=time_ms(lambda: torch.sparse.mm(W, dense), 5),
           extra=f" (max |plain| {big:.6g}; library err {lib_err:.3g})")
    del W, dense
    packed = fbp_fast.pack_filtered(filter_views(par, 1.0, a["par_H"],
                                                 par_m, dt))
    bargs = (packed, 4, a["par_thetas"], t0, dt, pnt, meta.n_matrix,
             meta.fov, np.pi / n_th)
    img, want, ms, pms = compare(
        lambda: fbp_fast.parallel_backproject_multi(*bargs),
        lambda: fbp_fast.parallel_backproject_multi_plain(*bargs), reps=3)
    err, big = max_err(img, want)
    n_disc = int(fbp_fast._fov_disc_mask(meta.n_matrix, meta.fov).sum())
    report(records, "parallel_backproject", err, ms, pms, err <= 1e-4,
           (nbytes(packed, img) + meta.n_matrix ** 2 + 8 * n_th,
            n_disc * n_th * (8 + 4 * 4)),
           extra=f" (max |plain| {big:.6g})")


def analytic_kernel_phase(arrays, meta, records):
    """Phase 3, analytic projector: K9 on the reference protocol's 8e5 fan
    rays through ``pelvis_analytic()``."""
    import math

    from dexct_tpu_torch.system import analytic

    a = arrays
    args = (a["an_params"], a["an_labels"], a["src"], a["dirs"])
    kw = dict(n_materials=meta.n_materials)
    paths, want, ms, pms = compare(
        lambda: analytic.analytic_paths(*args, **kw),
        lambda: analytic.analytic_paths_plain(*args, **kw), reps=3)
    err, big = max_err(paths, want)
    S = a["an_params"].shape[0]
    n_rays = paths.numel() // meta.n_materials
    per_ray = (30 * S + 2 * S * (2 * S - 1)
               + 2 * S * math.ceil(math.log2(2 * S)))
    report(records, "analytic_chords", err, ms, pms, err <= 1e-5 * big,
           (nbytes(*args, paths), n_rays * per_ray),
           extra=f" (max path {big:.6g} cm, S = {S})")


def check_counts_and_gn(label, paths, a, meta, pixel_block):
    """K2 (both spectra) and K3 against their plain versions on one path's
    own paths and counts, with both times; the records keep the reference
    protocol's rows."""
    import torch

    from dexct_tpu_torch.ops import matdecomp, spectral

    counts, rels, ms, pms = [], [], 0.0, 0.0
    for s in ("1", "2"):
        mu, i0 = a["mu_t" + s], a["i0_" + s]
        c, wc, k_ms, p_ms = compare(
            lambda: spectral.counts_from_paths(paths, mu, i0),
            lambda: spectral.counts_from_paths_plain(paths, mu, i0), reps=2)
        rels.append(float(((c - wc).abs() / wc.abs().clamp_min(1e-30))
                          .max()))
        ms, pms = ms + k_ms, pms + p_ms
        counts.append(c)
    n_rays = paths.numel() // paths.shape[-1]
    print(f"  spectral_counts on the {label} paths ({n_rays} rays): max rel"
          f" {max(rels):.3g} [max rel <= 1e-5]  kernel="
          f"{ms:.4f} ms  plain={pms:.4f} ms")
    if max(rels) > 1e-5:
        fail(f"spectral_counts disagrees with its plain version on the "
             f"{label} paths")
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    gkw = dict(n_iters=meta.n_iters, pixel_block=pixel_block,
               warm_nodes=meta.gn_warm_nodes)
    ab, want, ms, pms = compare(
        lambda: matdecomp.gauss_newton_solve(flat, a["dec_i0"], a["dec_mus"],
                                             **gkw),
        lambda: matdecomp.gauss_newton_solve_plain(flat, a["dec_i0"],
                                                   a["dec_mus"], **gkw),
        reps=1)
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    print(f"  gauss_newton on the {label} counts ({flat.shape[1]} pixels, "
          f"pixel_block {pixel_block}): rel {rel:.3g} [max |d| / max(|a|, 1)"
          f" <= 1e-4]  kernel={ms:.4f} ms  plain={pms:.4f} ms")
    if not (rel <= 1e-4 and bool(torch.isfinite(ab).all())):
        fail(f"gauss_newton disagrees with its plain version on the {label} "
             "counts")


def cone_kernel_phase(arrays, meta, records, helical):
    """Phase 3, 3-D paths: K10 on the circular config's rays, K2 and K3
    on each config's own paths and counts (4-D [V, R, C, M] paths, the
    decomposition in the step's pixel blocks), and K11 (or K12 on the
    helical config) on the filtered 4-volume stack of that path's own
    step."""
    import torch

    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.ops.fbp import filter_views
    from dexct_tpu_torch.pipeline import cone

    a = arrays
    V, R, C = meta.vrc
    if not helical:
        args = (a["labels"], a["src"], a["dirs"], meta.dx, meta.dy, meta.dz)
        kw = dict(n_materials=meta.n_materials)
        paths, want, ms, pms = compare(
            lambda: conebeam.trace_paths_3d(*args, **kw),
            lambda: conebeam.trace_paths_3d_plain(*args, **kw), reps=2)
        err = float((paths - want).abs().max())
        steps = walk_steps(paths, a["dirs"], (meta.dx, meta.dy, meta.dz))
        report(records, "siddon_trace_3d", err, ms, pms, err <= 1e-4,
               (nbytes(a["labels"], a["src"], a["dirs"], paths),
                7 * steps + 60 * V * R * C),
               extra=f" ({V * R * C} rays)")
    else:  # K10 at the helical rays, timed apart from the cone record
        args = (a["labels"], a["src"], a["dirs"], meta.dx, meta.dy, meta.dz)
        kw = dict(n_materials=meta.n_materials)
        paths, want, ms, pms = compare(
            lambda: conebeam.trace_paths_3d(*args, **kw),
            lambda: conebeam.trace_paths_3d_plain(*args, **kw), reps=2)
        err = float((paths - want).abs().max())
        print(f"  siddon_trace_3d on the helical rays ({V * R * C} rays): "
              f"max_abs_err={err:.6g}  kernel={ms:.4f} ms  plain={pms:.4f} "
              f"ms  [{KERNELS['siddon_trace_3d'][3]}]")
        if err > 1e-4:
            fail("siddon_trace_3d disagrees with its plain version on the "
                 "helical rays")
        del want
    # decompose_counts's pixel blocks, as the step solves them
    check_counts_and_gn("helical" if helical else "cone", paths, a, meta,
                        65536)
    out = cone.cone_dect_from_paths(paths, a, meta._replace(do_recon=False))
    del paths
    sinos = torch.stack([out["sino_log"][0], out["sino_log"][1],
                         out["mat_sinos"][0], out["mat_sinos"][1]])
    qs = filter_views(sinos, a["fdk_w"], a["filt_H"], meta.fft_len,
                      meta.dgamma).contiguous()
    K = qs.shape[0]
    X, Y, _ = conebeam._disc(meta.n_matrix, meta.fov, qs.device)
    P = X.shape[0]
    if helical:  # K12 in every gFDK weighting; the record is 'full''s
        hargs = (qs, a["betas"], a["src_z"], a["row_off"], a["beta_c"],
                 meta.sid, meta.dgamma, meta.row_h, R, meta.pitch,
                 meta.n_matrix, meta.nz_out, meta.fov, meta.dz_out, meta.z0)
        for w in conebeam.WEIGHTINGS:
            vol, want, ms, pms = compare(
                lambda w=w: conebeam._helical_backproject(
                    *hargs, dbeta=meta.dbeta, weighting=w),
                lambda w=w: conebeam._helical_backproject_plain(
                    *hargs, weighting=w), reps=1)
            err, big = max_err(vol, want)
            on, taps = helical_terms(a, meta, w, X, Y)
            work = (nbytes(qs, vol) + 8 * P + 16 * V,
                    PLANE_OPS * P * V
                    + (MOTION_ROW_OPS + WEIGHT_OPS[w]) * on
                    + (MOTION_TAP_OPS + 7 * K) * taps)
            extra = (f" (max |plain| {big:.6g}; {meta.nz_out} slices; "
                     f"{on} pixel-slice-views on the detector in the window,"
                     f" {taps} of them weighted)")
            if w == "full":
                report(records, "helical_backproject", err, ms, pms,
                       err <= 1e-4 * big, work, extra=extra)
                continue
            b_ms, by = bound(*work)
            print(f"  helical_backproject weighting {w:8s} "
                  f"max_abs_err={err:.6g}{extra}  kernel={ms:.4f} ms  "
                  f"plain={pms:.4f} ms  bound={b_ms:.4f} ms ({by})  "
                  f"[{KERNELS['helical_backproject'][3]}]")
            if not err <= 1e-4 * big:
                fail(f"helical_backproject ({w}) disagrees with its plain "
                     "version")
        return
    fargs = (qs, a["betas"], meta.sid, meta.dgamma, meta.row_h, R,
             meta.n_matrix, meta.nz_out, meta.fov, meta.dz_out, meta.dbeta)
    vol, want, ms, pms = compare(
        lambda: conebeam._fdk_backproject_multi(*fargs),
        lambda: conebeam._fdk_backproject_multi_plain(*fargs), reps=1)
    err, big = max_err(vol, want)
    zc = conebeam._fdk_z(meta.nz_out, meta.dz_out, 0.0, qs.device)
    taps = rows_on_detector(
        a["betas"], lambda beta: conebeam._inplane(
            X, Y, beta, meta.sid, meta.dgamma, C)[2:4],
        lambda inv_h: (zc[None, :, None] * meta.sid) * inv_h[:, None, :]
        / meta.row_h - 0.5 + R / 2.0, R)
    report(records, "fdk_backproject", err, ms, pms, err <= 1e-4 * big,
           (nbytes(qs, vol) + 8 * P + 8 * V,
            PLANE_OPS * P * V + MOTION_ROW_OPS * P * meta.nz_out * V
            + (MOTION_TAP_OPS + 7 * K) * taps),
           extra=f" (max |plain| {big:.6g}; {meta.nz_out} slices; {taps} "
                 f"of {P * meta.nz_out * V} pixel-slice-views on the "
                 f"detector)")


def rows_on_detector(betas, plane, row_index, R, block=8):
    """The (disc pixel, slice, view) terms whose row lies on the detector
    and whose pixel lies inside the fan: ``plane(beta)`` gives the
    per-(view, pixel) scale of the row position and the fan mask [B, P],
    ``row_index(scale)`` the row index [B, nz, P]; counted in blocks of
    ``block`` views."""
    n = 0
    for v0 in range(0, betas.shape[0], block):
        scale, inside = plane(betas[v0:v0 + block])
        ridx = row_index(scale)
        n += int(((ridx >= -0.5) & (ridx <= R - 0.5)
                  & (inside[:, None, :] != 0)).sum())
    return n


def helical_terms(a, meta, weighting, X, Y):
    """K12's work on the helical config in one weighting: the (disc pixel,
    slice, view) terms on the detector within the slice's window, and those
    of them whose weight is nonzero inside the fan (the terms that take
    taps), from the plain version's geometry and window in blocks of 8
    views."""
    from dexct_tpu_torch.ops import conebeam

    V, R, C = meta.vrc
    zc = conebeam._helical_z(meta.nz_out, meta.dz_out, meta.z0, X.device)
    k = conebeam._window_constants(weighting, C, meta.dgamma, meta.pitch,
                                   meta.row_h, R, meta.sid)
    on = taps = 0
    for v0 in range(0, V, 8):
        sl = slice(v0, v0 + 8)
        beta, sz = a["betas"][sl], a["src_z"][sl]
        _, _, inv_h, w_amp, gam, h2 = conebeam._inplane(
            X, Y, beta, meta.sid, meta.dgamma, C)
        zt = ((zc[None, :] - sz[:, None]) * meta.sid)[:, :, None] \
            * inv_h[:, None, :]
        ridx = zt / meta.row_h - 0.5 + R / 2.0 + a["row_off"][sl][:, None,
                                                                   None]
        d = (beta[:, None] - a["beta_c"][None, :])[:, :, None]
        w = conebeam._window_weight(
            weighting, k, d, gam[:, None, :], zt, zc[None, :, None],
            sz[:, None, None], h2[:, None, :], inv_h[:, None, :], meta.sid)
        live = (ridx >= -0.5) & (ridx <= R - 0.5) & (d.abs() <= k["hwpi"])
        on += int(live.sum())
        taps += int((live & (w != 0) & (w_amp[:, None, :] != 0)).sum())
    return on, taps


def stateless_stack(ccfg, spectra, dev):
    """The [4, V, R, C] stack (both log sinograms, both basis sinograms)
    that the stateless branch reconstructs, from its own trace, counts and
    decomposition."""
    import torch

    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect

    out = simulate_cone_dect(ccfg.ct, ccfg.phantom, *spectra(ccfg.ct),
                             ccfg.N_matrix, ccfg.FOV, ccfg.ramp, device=dev,
                             n_iters=50, do_recon=False)
    return torch.stack([out["sino_log"][0], out["sino_log"][1],
                        out["mat_sinos"][0], out["mat_sinos"][1]])


def flat_kernel_phase(ccfg, stack, records):
    """Phase 3, flat-panel path: K13 on the filtered 4-volume stack."""
    import torch

    from dexct_tpu_torch.ops import conebeam, flatpanel

    ct = ccfg.ct
    V, R, C = stack.shape[-3:]
    N = ccfg.N_matrix
    q = flatpanel._flat_filter(stack, ct, ccfg.ramp)
    bargs = (q, conebeam._f32(ct.betas, q.device), ct.SID, ct.du_iso,
             ct.h_iso, ct.det_offset_ch, ct.det_offset_row, R, N, R,
             ccfg.FOV, ct.h_iso, ct.rotation_total / V)
    vol, want, ms, pms = compare(
        lambda: flatpanel._flat_backproject(*bargs),
        lambda: flatpanel._flat_backproject_plain(*bargs), reps=1)
    err, big = max_err(vol, want)
    X, Y, _ = conebeam._disc(N, ccfg.FOV, q.device)
    P = X.shape[0]
    zc = flatpanel._flat_z(R, ct.h_iso, q.device)
    sid = float(ct.SID)

    def plane(beta):  # K13's 1 / ell and its fan test
        cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
        ell = sid - (X[None, :] * cb + Y[None, :] * sb)
        vt = -X[None, :] * sb + Y[None, :] * cb
        cidx = -sid * vt / ell / ct.du_iso - 0.5 - ct.det_offset_ch + C / 2
        return 1.0 / ell, ((cidx >= 0.0) & (cidx <= C - 1.0)).float()

    taps = rows_on_detector(
        conebeam._f32(ct.betas, q.device), plane,
        lambda inv_ell: (zc[None, :, None] * sid) * inv_ell[:, None, :]
        / ct.h_iso - 0.5 - ct.det_offset_row + R / 2.0, R)
    report(records, "flat_backproject", err, ms, pms, err <= 1e-4 * big,
           (nbytes(q, vol) + 8 * P + 8 * V,
            PLANE_OPS * P * V + MOTION_ROW_OPS * P * R * V
            + (MOTION_TAP_OPS + 7 * q.shape[0]) * taps),
           extra=f" (max |plain| {big:.6g}; {R} slices; {taps} of "
                 f"{P * R * V} pixel-slice-views on the detector)")


def tilted_kernel_phase(ccfg, stack, records):
    """Phase 3, tilted path: K11 on the enlarged gantry grid (timed), then
    K16 resampling its four volumes onto the patient grid; the yardstick is
    ``grid_sample``, trilinear with zero padding, which differs from the
    reference at the box's faces (it weights the corners inside)."""
    import torch
    import torch.nn.functional as F

    from dexct_tpu_torch.ops import conebeam

    ct = ccfg.ct
    V, R, C = stack.shape[-3:]
    N, fov, dz, tau = ccfg.N_matrix, ccfg.FOV, ct.h_iso, ct.tilt
    ct_g = ct.untilted()
    n_g, fov_g, nz_g = conebeam._tilted_grid(tau, N, fov, R, dz)
    q = conebeam._fdk_filter(stack, conebeam._fdk_weights(ct_g), ct_g,
                             ccfg.ramp, "sinc")
    fargs = (q, conebeam._f32(ct_g.betas, q.device), ct_g.SID, ct_g.dgamma,
             ct_g.h_iso, R, n_g, nz_g, fov_g, dz, ct_g.rotation_total / V)
    vols = conebeam._fdk_backproject_multi(*fargs)
    k11 = time_ms(lambda: conebeam._fdk_backproject_multi(*fargs), 1)
    print(f"  fdk_backproject on the tilted gantry grid ({n_g}^2 x {nz_g}): "
          f"kernel={k11:.4f} ms")
    idx = conebeam._tilted_indices(tau, N, fov, R, dz, q.device)
    # what the wrapper allocates: the output and nothing else (no index
    # copy), not even for a moment; the bytes requested of the caching
    # allocator, which may hand out a larger cached block
    def requested(which):
        return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = requested("current")
    out = conebeam._trilinear_volume_sample(vols, *idx)
    torch.cuda.synchronize()
    extra = requested("current") - mem0 - nbytes(out)
    peak = requested("peak") - mem0 - nbytes(out)
    print(f"  trilinear_sample allocates {extra} B beyond its "
          f"{nbytes(out)} B output, {peak} B at its peak [0]")
    if extra or peak:
        fail("K16's wrapper allocates beyond its output (an index copy)")
    del out
    out, want, ms, pms = compare(
        lambda: conebeam._trilinear_volume_sample(vols, *idx),
        lambda: conebeam._trilinear_volume_sample_plain(vols, *idx), reps=5)
    err, big = max_err(out, want)
    # grid_sample's (x, y, z) in [-1, 1] at the box's corner centres
    shape = out.shape[1:]
    grid = torch.stack([
        (t / (n - 1) * 2.0 - 1.0).expand(shape) for t, n in
        ((idx[2], n_g), (idx[1], n_g), (idx[0], nz_g))], -1)[None]

    def library():
        return F.grid_sample(vols[None], grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)[0]

    lib_err = float((library() - want).abs().max())
    dev_ms = graph_ms(lambda: conebeam._trilinear_volume_sample(vols, *idx))
    print(f"  trilinear_sample device time (CUDA graph of 20 calls): "
          f"{dev_ms:.4f} ms; grid_sample {graph_ms(library):.4f} ms")
    # the gantry cells the function needs: the eight corners of every
    # point's stencil (the rotated patient slab covers part of the grid)
    corner = [torch.clamp(torch.floor(t.expand(shape)), 0, n - 2).long()
              .reshape(-1) for t, n in ((idx[0], nz_g), (idx[1], n_g),
                                        (idx[2], n_g))]
    cells = torch.unique(torch.cat([
        ((corner[0] + a) * n_g + corner[1] + b) * n_g + corner[2] + c
        for a in (0, 1) for b in (0, 1) for c in (0, 1)])).numel()
    report(records, "trilinear_sample", err, ms, pms, err == 0.0,
           (4 * vols.shape[0] * cells + nbytes(*idx, out),
            out.numel() * 40),
           library_ms=time_ms(library, 5),
           extra=f" (bitwise; max |plain| {big:.6g}; {nz_g} x {n_g}^2 -> "
                 f"{R} x {N}^2, {cells} of {vols[0].numel()} cells touched; "
                 f"library err {lib_err:.3g})")


def zffs_kernel_phase(ccfg, stack):
    """Phase 3, z-FFS path: K12 as the circular z flying focal spot runs
    it, pitch 0 with nonzero per-view row offsets (the helical record stays
    the helical config's)."""
    import numpy as np

    from dexct_tpu_torch.ops import conebeam

    ct = ccfg.ct
    V, R, C = stack.shape[-3:]
    dev = stack.device
    q = conebeam._fdk_filter_zffs(stack, ct, ccfg.ramp)
    off = np.asarray(ct.ffs_view_offsets, np.float64)
    row_off = off * ct.SID / (ct.SDD * ct.h_iso)
    z0 = (0.5 - R / 2.0) * ct.h_iso
    hargs = (q, conebeam._f32(ct.betas, dev), conebeam._f32(off, dev),
             conebeam._f32(row_off, dev),
             conebeam._f32(np.full(R, 0.5 * ct.rotation_total), dev),
             ct.SID, ct.dgamma, ct.h_iso, R, 0.0, ccfg.N_matrix, R, ccfg.FOV,
             ct.h_iso, z0)
    vol, want, ms, pms = compare(
        lambda: conebeam._helical_backproject(
            *hargs, dbeta=ct.rotation_total / V),
        lambda: conebeam._helical_backproject_plain(*hargs), reps=1)
    err, big = max_err(vol, want)
    print(f"  helical_backproject at pitch 0 with the z-FFS row offsets "
          f"(|row_off| {abs(row_off).max():.4g} rows): max_abs_err={err:.6g}"
          f" (max |plain| {big:.6g})  kernel={ms:.4f} ms  plain={pms:.4f} ms"
          f"  [{KERNELS['helical_backproject'][3]}]")
    if err > 1e-4 * big:
        fail("helical_backproject disagrees with its plain version at the "
             "z-FFS row offsets")


def katsevich_kernel_phase(ccfg, stack, records):
    """Phase 3, Katsevich path on the helical config: K14 (with its cuFFT
    spectral derivative) on the 4-volume stack, then K15 on the chain's
    filtered data."""
    import math

    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, katsevich

    ct = ccfg.ct
    V, R, C = stack.shape[-3:]
    N, fov = ccfg.N_matrix, ccfg.FOV
    arrays, st = katsevich._host_prep(
        stack.shape, ct, N, fov, z_out=None, n_psi=128, taper=None,
        interp="linear", deriv="spectral", ramp=ccfg.ramp, window="sinc",
        device=stack.device)
    dargs = (stack, arrays["cosk"], st["dbeta"], st["dgamma"])
    kw = dict(deriv="spectral", ramp=ccfg.ramp, window="sinc")
    g1, want, ms, pms = compare(
        lambda: katsevich._fixed_direction_derivative(*dargs, **kw),
        lambda: katsevich._fixed_direction_derivative_plain(*dargs, **kw),
        reps=5)
    err, big = max_err(g1, want)
    L = 1 << math.ceil(math.log2(2 * C))  # the spectral derivative's FFT
    rows = stack.numel() // C
    report(records, "katsevich_derivative", err, ms, pms, err <= 1e-5 * big,
           (nbytes(stack, arrays["cosk"], g1),
            stack.numel() * 12 + rows * (5 * L * math.log2(L) + 3 * L)),
           extra=f" (max |plain| {big:.6g}; spectral, FFT length {L})")
    del g1, want
    gf = katsevich._katsevich_filter(
        stack, arrays["Wf"], arrays["Wb"], arrays["kern_im"], arrays["cosk"],
        dbeta=st["dbeta"], dgamma=st["dgamma"], deriv="spectral",
        ramp=ccfg.ramp, window="sinc", fft_len=st["fft_len"])
    bargs = (gf, arrays["betas"], arrays["src_z"], st["sid"], st["dgamma"],
             st["row_h"], st["n_rows"], st["pitch"], N, st["nz_out"], fov,
             st["dz_out"], st["z0"])
    vol, want, ms, pms = compare(
        lambda: katsevich._katsevich_backproject(
            *bargs, st["beta_mid"], st["dbeta"], st["taper"]),
        lambda: katsevich._katsevich_backproject_plain(
            *bargs, st["dbeta"], st["taper"]), reps=1)
    err, big = max_err(vol, want)
    X, Y, _ = conebeam._disc(N, fov, gf.device)
    P = X.shape[0]
    # the views each slice visits: source z within the TD window's reach
    reach = katsevich._z_reach(st["pitch"], C, st["dgamma"], st["taper"],
                               st["sid"], fov)
    zc = st["z0"] + np.arange(st["nz_out"]) * st["dz_out"]
    visits = int((np.abs(zc[:, None] - np.asarray(ct.source_z)[None, :])
                  <= reach).sum())
    # the terms the function needs: (pixel, slice, view) with a nonzero
    # weight, on the detector and inside the tapered TD window
    zc_t = katsevich._katsevich_z(st["nz_out"], st["dz_out"], st["z0"],
                                  gf.device)
    betas = arrays["betas"].to(torch.float32)
    src_z = arrays["src_z"].to(torch.float32)
    terms = 0
    for v0 in range(0, V, 8):
        w = katsevich._pi_terms(
            X, Y, zc_t, betas[v0:v0 + 8], src_z[v0:v0 + 8], st["sid"],
            st["dgamma"], st["row_h"], R, C, st["pitch"] / (4.0 * np.pi),
            st["taper"])[2]
        terms += int((w != 0).sum())
    report(records, "katsevich_backproject", err, ms, pms, err <= 1e-4 * big,
           (nbytes(gf, vol) + 8 * P + 12 * V,
            terms * (60 + 7 * gf.shape[0])),
           extra=f" (max |plain| {big:.6g}; {st['nz_out']} slices; "
                 f"{terms} weighted pixel-slice-views of {P * visits} in "
                 f"reach)")


def mono_mu(phantom, dev):
    """The phantom's per-label attenuation [1/cm] at MONO_KEV, float32."""
    import numpy as np
    import torch

    return torch.as_tensor(
        phantom.materials.mu_table(np.array([MONO_KEV]))[:, 0],
        dtype=torch.float32, device=dev)


def cone_rays(ct, dev):
    import torch

    return (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
            for x in ct.ray_geometry_3d())


def project_kernel_phase(ccfg, records):
    """Phase 3, exact 3-D projector on the cone config: K18 on mu[labels] at
    60 keV over the 1.47M rays (also against K10's paths . mu), K19 on a
    random sinogram with the dot-product identity on random x and y; the
    library yardstick is the system matrix as a CSR product on every tenth
    view, scaled to all views."""
    import torch

    from dexct_tpu_torch.ops import conebeam

    ct, ph = ccfg.ct, ccfg.phantom
    dev = torch.device("cuda")
    src, dirs = cone_rays(ct, dev)
    labels = conebeam.labels_u8(ph.labels, dev)
    mu = mono_mu(ph, dev)
    vol = mu[labels.long()].contiguous()
    vox = (ph.dx, ph.dy, ph.dz)
    shape = tuple(vol.shape)
    sino, want, ms, pms = compare(
        lambda: conebeam.project_volume_3d(vol, src, dirs, *vox),
        lambda: conebeam.project_volume_3d_plain(vol, src, dirs, *vox),
        reps=3)
    err, big = max_err(sino, want)
    paths = conebeam.trace_paths_3d(labels, src, dirs, *vox,
                                    n_materials=ph.n_materials)
    ref = paths @ mu
    k10_err = float((sino - ref).abs().max())
    steps = walk_steps(paths, dirs, vox)
    n_rays = sino.numel()
    del paths, want

    # every tenth view's rows of the system matrix, from the plain walk
    every = 10
    s_sub = src[::every].reshape(-1, 3)
    d_sub = dirs[::every].reshape(-1, 3)
    n_sub = s_sub.shape[0]
    rows, cols, vals = [], [], []
    ray = torch.arange(n_sub, device=dev)
    for lin, seg in conebeam._walk_3d(shape, s_sub, d_sub, *vox,
                                      conebeam._max_steps(shape)):
        keep = seg > 0
        rows.append(ray[keep])
        cols.append(lin[keep])
        vals.append(seg[keep])
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    nnz = vals.numel()
    A = sparse_taps(rows, cols, vals, (n_sub, vol.numel()))
    At = sparse_taps(cols, rows, vals, (vol.numel(), n_sub))
    del rows, cols, vals
    scale = n_rays / n_sub
    x1 = vol.reshape(-1, 1)
    lib_err = float((torch.sparse.mm(A, x1).reshape(-1)
                     - sino[::every].reshape(-1)).abs().max())
    lib_fwd = time_ms(lambda: torch.sparse.mm(A, x1), 5) * scale
    fwd_dev_ms = graph_ms(
        lambda: conebeam.project_volume_3d(vol, src, dirs, *vox))
    report(records, "project_3d", err, ms, pms,
           err <= 1e-4 * big and k10_err <= 1e-4 * float(ref.abs().max()),
           (nbytes(vol, src, dirs, sino), 9 * steps + 60 * n_rays),
           library_ms=lib_fwd,
           extra=f" (max |plain| {big:.6g}; {n_rays} rays through "
                 f"{shape}; against K10's paths . mu {k10_err:.3g}; library "
                 f"= CSR torch.sparse.mm on every {every}th view ({nnz} "
                 f"nonzeros) x {scale:g}, err {lib_err:.3g}; device "
                 f"{fwd_dev_ms:.4f} ms, CUDA graph of 20 calls)")
    walk_ops = 9 * steps + 60 * n_rays
    del A
    torch.cuda.empty_cache()

    # K19's table: the kernels' build against the plain builder's
    table, build_ms, plain_ms, same = transpose_phase(
        conebeam, src, dirs, shape, vox)
    report(records, "cone_transpose", 0.0 if same else float("inf"),
           build_ms, plain_ms, same,
           (nbytes(src, dirs) + table.nbytes, walk_ops),
           extra=f" ({table.nnz} entries in {table.slots} slots, padding "
                 f"{table.slots / table.nnz - 1:.4f}; {table.nbytes} B in "
                 f"{len(table.blocks)} block(s); against the plain builder: "
                 f"{'bitwise equal' if same else 'DIFFERENT'})")

    gen = torch.Generator(device=dev).manual_seed(6)
    y = torch.randn(sino.shape, generator=gen, device=dev)
    x = torch.randn(shape, generator=gen, device=dev)

    def k19():
        return conebeam.project_volume_3d_adjoint(y, src, dirs, shape, *vox,
                                                  table=table)

    back, want, ms, pms = compare(
        k19, lambda: conebeam.project_volume_3d_adjoint_plain(
            y, src, dirs, shape, *vox), reps=3)
    err, big = max_err(back, want)
    del want
    twice = torch.equal(k19(), back)
    dev_ms = graph_ms(k19)
    with_build_ms = time_ms(lambda: conebeam.project_volume_3d_adjoint(
        y, src, dirs, shape, *vox), 2)
    lhs = float((conebeam.project_volume_3d(x, src, dirs, *vox).double()
                 * y.double()).sum())
    rhs = float((x.double() * back.double()).sum())
    ident = abs(lhs - rhs) / abs(lhs)
    del table
    torch.cuda.empty_cache()
    # every 30th view: the CPU's plain version, index_add_ one step after
    # another, against K19 over its own table
    s30, d30, y30 = (t[::30].contiguous() for t in (src, dirs, y))
    got30 = conebeam.project_volume_3d_adjoint(y30, s30, d30, shape, *vox)
    cpu30 = torch.equal(got30.cpu(), conebeam.project_volume_3d_adjoint_plain(
        y30.cpu(), s30.cpu(), d30.cpu(), shape, *vox))
    y1 = y[::every].reshape(-1, 1).contiguous()
    lib_adj = time_ms(lambda: torch.sparse.mm(At, y1), 5) * scale
    print(f"  backproject_3d: device {dev_ms:.4f} ms (CUDA graph of 20 "
          f"calls; K18 {fwd_dev_ms:.4f}), with a build per call "
          f"{with_build_ms:.3f} ms; two launches bitwise equal: {twice}; "
          f"bitwise equal to the CPU's plain version on every 30th view: "
          f"{cpu30}")
    report(records, "backproject_3d", err, ms, pms,
           err <= 1e-4 * big and ident <= 1e-4 and twice and cpu30,
           (nbytes(y, src, dirs, back), walk_ops),
           library_ms=lib_adj,
           extra=f" (max |plain| {big:.6g}; <Ax, y> = {lhs:.8g}, <x, A^T y>"
                 f" = {rhs:.8g}, rel {ident:.3g}; library = CSR of A^T on "
                 f"every {every}th view x {scale:g})")
    del At


def transpose_phase(conebeam, src, dirs, shape, vox):
    """K19's table built by its kernels (the least of three builds, host
    clock, synchronised) and by the plain builder (once), compared field
    for field: (the kernels' table, build ms, plain ms, equal)."""
    import torch

    times = []
    for _ in range(3):
        table = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = conebeam.cone_transpose(src, dirs, shape, *vox)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    plain = conebeam.cone_transpose_plain(src, dirs, shape, *vox)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = (len(table.blocks) == len(plain.blocks)
            and all(torch.equal(a, b) for ga, gb in zip(table.blocks,
                                                        plain.blocks)
                    for a, b in zip(ga[:3], gb[:3])))
    print(f"  cone_transpose builds (ms): "
          + ", ".join(f"{t:.2f}" for t in times)
          + f"; plain builder {plain_ms:.1f}")
    del plain
    torch.cuda.empty_cache()
    return table, min(times), plain_ms, same


def pi_kernel_phase(ccfg, records, dev):
    """Phase 3, cone-parallel PI method on the helical config's
    monoenergetic sinogram (60 keV): K5 at 4 taps on the 16 detector rows
    (the library yardstick the same taps as a CSR product), then K20 on the
    filtered lines (nt = 512, 19 slices)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, fbp_fast, helical_pi
    from dexct_tpu_torch.ops.fbp import filter_views
    from dexct_tpu_torch.ops.filters import filter_frequency_response
    from dexct_tpu_torch.ops.siddon import mono_sinogram

    ct, ph = ccfg.ct, ccfg.phantom
    V, R, C = ct.N_proj, ct.N_rows, ct.N_channels
    src, dirs = cone_rays(ct, dev)
    sino = mono_sinogram(conebeam.trace_paths_3d(
        conebeam.labels_u8(ph.labels, dev), src, dirs, ph.dx, ph.dy, ph.dz,
        n_materials=ph.n_materials), mono_mu(ph, dev))
    del src, dirs
    nt = 2 * C
    cosk = ct.SID / np.sqrt(ct.SID ** 2 + np.asarray(ct.z_iso) ** 2)
    rows = (sino * conebeam._f32(cosk, dev)[None, :, None]).permute(
        1, 0, 2).contiguous()
    idx, w, t0, dt, thetas = helical_pi._conepar_rebin_plan(ct, nt)
    idx, w = torch.as_tensor(idx, device=dev), torch.as_tensor(w, device=dev)
    par, want, ms, pms = compare(
        lambda: fbp_fast.rebin_to_parallel(rows, idx, w, nt, taps=4),
        lambda: fbp_fast.rebin_to_parallel_plain(rows, idx, w, nt, taps=4),
        reps=5)
    err, big = max_err(par, want)
    n_bins = V * nt
    first = idx.reshape(-1, 4)[:, 0::2].to(torch.int64)
    cols = torch.stack([first, first + 1], -1).reshape(-1)
    W = sparse_taps(torch.arange(n_bins, device=dev).repeat_interleave(4),
                    cols, w, (n_bins, V * C))
    dense = rows.reshape(R, -1).T.contiguous()
    lib_err = float((torch.sparse.mm(W, dense).T.reshape(par.shape)
                     - want).abs().max())
    lib_ms = time_ms(lambda: torch.sparse.mm(W, dense), 5)
    del W, dense
    b_ms, by = bound(nbytes(rows, idx, w, par), n_bins * 4 * 2 * R)
    print(f"  rebin_to_parallel at 4 taps (PI plan, {V} x {nt} bins, K = {R}"
          f" rows): max_abs_err={err:.6g} (max |plain| {big:.6g})  kernel="
          f"{ms:.4f} ms  plain={pms:.4f} ms  bound={b_ms:.4f} ms ({by})  "
          f"library={lib_ms:.4f} ms (CSR torch.sparse.mm, err {lib_err:.3g})"
          f"  [{KERNELS['rebin_to_parallel'][3]}]")
    if err > 1e-5 * big:
        fail("rebin_to_parallel disagrees with its plain version at 4 taps")
    H, m = filter_frequency_response(nt, dt, ccfg.ramp, "sinc", "parallel")
    parf = filter_views(par, 1.0, conebeam._f32(H, dev), m,
                        dt).permute(1, 2, 0).contiguous()
    del par, want
    z_out = helical_pi._default_z(ct, float(ct.pitch))
    th = torch.as_tensor(thetas, device=dev)
    N, fov = ccfg.N_matrix, ccfg.FOV
    args = (parf, ct.SID, ct.h_iso, R, float(ct.pitch),
            float(np.asarray(ct.source_z)[0]), th, t0, dt, nt, N, len(z_out),
            fov, float(z_out[1] - z_out[0]), float(z_out[0]),
            float(ct.rotation_total / V))
    vol, want, ms, pms = compare(
        lambda: helical_pi._pi_backproject(*args),
        lambda: helical_pi._pi_backproject_plain(*args), reps=1)
    err, big = max_err(vol, want)
    # the terms the function needs: (line, slice, pixel) of nonzero weight
    # take the copies' windows and the taps (~230 operations); every other
    # one its t and channel test (8)
    X, Y, _ = conebeam._disc(N, fov, dev)
    zc = conebeam._f32(z_out, dev)[None, :, None]
    terms = 0
    for v0 in range(0, V, 8):
        terms += int((helical_pi._pi_terms(
            X, Y, zc, th[v0:v0 + 8], th, ct.SID, ct.h_iso, R,
            float(ct.pitch), float(np.asarray(ct.source_z)[0]), t0, dt,
            nt)[5] != 0).sum())
    P = X.shape[0]
    report(records, "pi_backproject", err, ms, pms, err <= 1e-4 * big,
           (nbytes(parf, vol) + 8 * P + 12 * V,
            P * len(z_out) * V * 8 + terms * 230),
           extra=f" (max |plain| {big:.6g}; {len(z_out)} slices, {V} lines "
                 f"x {nt} x {R}; {terms} weighted pixel-slice-lines of "
                 f"{P * len(z_out) * V})")


def zstack_workload():
    """The z-stack workload: the geometry, the 8-slice rolled pelvis and the
    JAX bench's spectra (linac 9 mGy, 80 kV 1 mGy)."""
    import dataclasses

    import numpy as np

    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.system import FanBeamGeometry, pelvis_phantom

    ct = FanBeamGeometry(N_channels=800, N_proj=1000, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = pelvis_phantom(N=512, dx=0.1)
    labs = np.stack([np.roll(ph.labels[0], 7 * k, axis=1)
                     for k in range(ZSTACK_NZ)])
    ph = dataclasses.replace(ph, labels=labs)
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, ph, s1, s2


def zstack_kernel_phase(work, records, dev):
    """Phase 3, z-stack: K17 on the 8 slices against its plain version, and
    bitwise against K1 on each slice; K1 over the 8 slices is the
    yardstick."""
    import torch

    from dexct_tpu_torch.ops import siddon

    ct, ph, _, _ = work
    nz, m = ph.labels.shape[0], ph.n_materials
    src, dirs = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in ct.ray_geometry())
    lab = siddon.labels_stack_tensor(ph.labels, dev)
    args = (lab, src, dirs, ph.dx, ph.dy)
    paths, want, ms, pms = compare(
        lambda: siddon.trace_paths_stack(*args, n_materials=m),
        lambda: siddon.trace_paths_stack_plain(*args, n_materials=m), reps=2)
    err = float((paths - want).abs().max())
    del want

    def per_slice():
        return [siddon.trace_paths(lab[z], src, dirs, ph.dx, ph.dy,
                                   n_materials=m) for z in range(nz)]

    same = all(torch.equal(paths[z], k1) for z, k1 in enumerate(per_slice()))
    k1_ms = time_ms(per_slice, 2)
    steps = walk_steps(paths[0], dirs, (ph.dx, ph.dy))
    n_rays = paths[0].numel() // m
    report(records, "siddon_trace_stack", err, ms, pms, err <= 1e-4 and same,
           (nbytes(lab, src, dirs, paths),
            (6 + 2 * nz) * steps + 40 * n_rays),
           extra=f" ({nz} slices x {n_rays} rays, {siddon.slice_chunk(nz, m)}"
                 f" slices per walk; bitwise equal to K1 on every slice: "
                 f"{same}; K1 over the {nz} slices {k1_ms:.4f} ms)")
    if not same:
        fail("siddon_trace_stack differs from K1 on a slice")


def ffs_kernel_phase(cfg, spectra, dev):
    """Phase 3, in-plane FFS path: K5 at 16 taps on the reference
    protocol's FFS plan (500 x 1600 bins), on the path's four sinograms
    (both logs, both basis sinograms); the library yardstick is the same
    taps as one CSR product.  The path rebins one image per launch: that
    time too."""
    import torch

    from dexct_tpu_torch.ops import fbp_fast
    from dexct_tpu_torch.ops.ffs import parallel_rebin_plan_ffs
    from dexct_tpu_torch.pipeline.api import simulate_dect

    ct = cfg.ct
    t0 = time.perf_counter()
    idx, w, _, _ = parallel_rebin_plan_ffs(ct)
    plan_ms = (time.perf_counter() - t0) * 1e3
    out = simulate_dect(ct, cfg.phantom, *spectra(ct), cfg.N_matrix, cfg.FOV,
                        cfg.ramp, device=dev, n_iters=50, do_recon=False)
    sinos = torch.stack([out.sino_log[0], out.sino_log[1],
                         out.mat_sinos[0], out.mat_sinos[1]])
    nt, taps, K = 2 * ct.N_channels, 16, sinos.shape[0]
    idx = torch.as_tensor(idx, device=dev)
    w = torch.as_tensor(w, device=dev)
    rargs = (sinos, idx, w, nt)
    par, want, ms, pms = compare(
        lambda: fbp_fast.rebin_to_parallel(*rargs, taps=taps),
        lambda: fbp_fast.rebin_to_parallel_plain(*rargs, taps=taps), reps=5)
    err, big = max_err(par, want)
    vc = sinos[0].numel()
    first = idx.reshape(-1, taps)[:, 0::2].to(torch.int64)
    cols = torch.stack([first, (first + 1) % vc], -1).reshape(-1)
    n_bins = first.shape[0]
    W = sparse_taps(torch.arange(n_bins, device=dev).repeat_interleave(taps),
                    cols, w, (n_bins, vc))
    dense = sinos.reshape(K, -1).T.contiguous()
    lib_err = float((torch.sparse.mm(W, dense).T.reshape(par.shape)
                     - want).abs().max())
    lib_ms = time_ms(lambda: torch.sparse.mm(W, dense), 5)
    del W, dense
    one = sinos[:1].contiguous()
    one_ms = time_ms(lambda: fbp_fast.rebin_to_parallel(one, idx, w, nt,
                                                        taps=taps), 5)
    bound_ms, by = bound(nbytes(sinos, idx, w, par), n_bins * taps * 2 * K)
    print(f"  rebin_to_parallel at 16 taps (FFS plan, {par.shape[1]} x {nt} "
          f"bins, K = {K}): max_abs_err={err:.6g} (max |plain| {big:.6g})  "
          f"kernel={ms:.4f} ms  plain={pms:.4f} ms  bound={bound_ms:.4f} ms "
          f"({by})  library={lib_ms:.4f} ms (CSR torch.sparse.mm, err "
          f"{lib_err:.3g}); K = 1 as the path launches it {one_ms:.4f} ms; "
          f"host plan {plan_ms:.1f} ms  [{KERNELS['rebin_to_parallel'][3]}]")
    if err > 1e-5 * big:
        fail("rebin_to_parallel disagrees with its plain version at 16 taps")


def realism_setup(cfg, spectra, dev):
    """The realism paths' inputs at the reference protocol: the spectra,
    the JAX study's bowtie (``design_flattening_bowtie(ct, 15.0)``, 31
    thickness levels) and the exact paths (K1)."""
    from dexct_tpu_torch.ops.bowtie import design_flattening_bowtie
    from dexct_tpu_torch.ops.siddon import material_path_sinogram

    s1, s2 = spectra(cfg.ct)
    bt = design_flattening_bowtie(cfg.ct, BOWTIE_RADIUS_CM)
    paths = material_path_sinogram(cfg.phantom, cfg.ct, device=dev)
    return s1, s2, bt, paths


def k28_case(paths, mu, tab, tab2, stride, reps=5):
    """K28 against its plain twin on one table (and its second table when
    given): (max abs err, max rel err, ms, plain ms, bytes, operations,
    counts)."""
    from dexct_tpu_torch.ops import spectral

    def kernel():
        return spectral.counts_from_table(paths, mu, tab, tab2,
                                          stride=stride)

    def plain():
        out = spectral.counts_from_table_plain(paths, mu, tab,
                                               stride=stride)
        if tab2 is None:
            return out
        return out, spectral.counts_from_table_plain(paths, mu, tab2,
                                                     stride=stride)

    got, want, ms, pms = compare(kernel, plain, reps)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs, rels = [], []
    for x, y in zip(got, want):
        errs.append(float((x - y).abs().max()))
        rels.append(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max()))
    n_rays, e = got[0].numel(), mu.shape[1]
    m = paths.shape[-1]
    work_b = nbytes(paths, mu, tab, *got) + (0 if tab2 is None
                                             else nbytes(tab2))
    work_ops = n_rays * e * (2 * m + 3 + (0 if tab2 is None else 2))
    return max(errs), max(rels), ms, pms, work_b, work_ops, got[0]


def k29_case(counts, group, i0_g, mus, n_iters, reps=2):
    """K29 against its plain twin: (max abs err, max err / max(|a|, 1),
    ms, plain ms, bytes, operations, a)."""
    import types

    from dexct_tpu_torch.ops import matdecomp

    kw = dict(n_iters=n_iters)
    ab, want, ms, pms = compare(
        lambda: matdecomp.gauss_newton_solve_grouped(counts, group, i0_g,
                                                     mus, **kw),
        lambda: matdecomp.gauss_newton_solve_grouped_plain(
            counts, group, i0_g, mus, **kw), reps)
    err = float((ab - want).abs().max())
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    b, ops = gn_work(counts, ab, mus.shape[1],
                     types.SimpleNamespace(n_iters=n_iters),
                     n_tables=i0_g.shape[0])
    return err, rel, ms, pms, b, ops, ab


def realism_kernel_phase(cfg, cone_cfg, spectra, records, dev):
    """Phase 3, the realism paths: K28 (table-indexed counts) on the
    bowtie's per-channel tables at the reference protocol (both spectra,
    with and without the second-moment table) and on the anode heel's
    per-row tables at the cone config; K29 (the grouped Gauss-Newton solve)
    on the 31 bowtie groups at the reference protocol (50 iterations) and
    on the 16 heel rows at the cone config, each against its plain twin;
    and K29 with one group bitwise against K3 on the same counts."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.ops.bowtie import (bowtie_fluence,
                                            bowtie_second_moment)
    from dexct_tpu_torch.ops.conebeam import cone_material_paths
    from dexct_tpu_torch.ops.heel import HeelEffect, heel_fluence

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    ct, ph = cfg.ct, cfg.phantom
    s1, s2, bt, paths = realism_setup(cfg, spectra, dev)
    counts, errs, rels, ms, pms, wb, wo = [], [], [], 0.0, 0.0, 0, 0
    for s in (s1, s2):
        mu = f32(ph.materials.mu_table(s.E))
        tab = f32(bowtie_fluence(s, ct, bt))
        tab2 = f32(bowtie_second_moment(s, ct, bt))
        e, r, t, tp, b, o, c = k28_case(paths, mu, tab, None, 1)
        e2, r2, _, _, _, _, _ = k28_case(paths, mu, tab, tab2, 1, reps=1)
        errs += [e, e2]
        rels += [r, r2]
        ms, pms, wb, wo = ms + t, pms + tp, wb + b, wo + o
        counts.append(c)
    report(records, "table_counts", max(errs), ms, pms, max(rels) <= 1e-5,
           (wb, wo), extra=f" (bowtie, {len(bt.groups()[0])} levels x "
           f"{ct.N_channels} channels; max rel {max(rels):.3g})")

    levels, gidx = bt.groups()
    ee, i0_base, mus_h = matdecomp.prepare_decomposition(ct, s1, s2)
    mu_bt = bt.material.linear_atten(ee)
    i0_g = f32(i0_base[None] * np.exp(-np.outer(levels, mu_bt))[:, None])
    mus = f32(mus_h)
    V, C = counts[0].shape
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    group = torch.as_tensor(gidx, device=dev).expand(V, C).reshape(-1)
    n_g = np.bincount(gidx)
    slots = int(sum(-(-n * V // 128) * 128 for n in n_g))
    err, rel, t, tp, b, o, _ = k29_case(flat, group, i0_g, mus, 50)
    report(records, "gauss_newton_grouped", err, t, tp, rel <= 1e-4, (b, o),
           extra=f" (rel {rel:.3g}; {len(levels)} groups, {slots} pixel "
           f"slots for {V * C} pixels; the vmap's {len(levels)} x "
           f"{int(n_g.max())} x {V} = {len(levels) * int(n_g.max()) * V})")
    # K29 with one group runs K3's per-pixel body on K3's tables
    one = matdecomp.gauss_newton_solve_grouped(
        flat, torch.zeros_like(group), i0_g[:1], mus, n_iters=50)
    k3 = matdecomp.gauss_newton_solve(flat, i0_g[0], mus, n_iters=50)
    k3_ms = time_ms(lambda: matdecomp.gauss_newton_solve(
        flat, i0_g[0], mus, n_iters=50), 2)
    print(f"  K29 with one group bitwise equal to K3: {torch.equal(one, k3)};"
          f" K3 on the same {V * C} counts (unfiltered table): {k3_ms:.4f} "
          "ms")
    if not torch.equal(one, k3):
        fail("K29 with one group differs from K3")
    del paths, counts, flat, one, k3
    torch.cuda.empty_cache()

    # the anode heel on the cone config: one table row per detector row
    cct, cph = cone_cfg.ct, cone_cfg.phantom
    heel = HeelEffect(d0_cm=HEEL_D0_CM)
    cpaths = cone_material_paths(cph, cct, device=dev)
    hc = []
    for s in spectra(cct):
        mu = f32(cph.materials.mu_table(s.E))
        tab = f32(heel_fluence(s, cct, heel))
        e, r, t, tp, b, o, c = k28_case(cpaths, mu, tab, None,
                                        cpaths.shape[2])
        hc.append(c)
        report(records, "table_counts", e, t, tp, r <= 1e-5, (b, o),
               extra=f" (heel, {tab.shape[0]} rows; max rel {r:.3g})",
               record=False)
    del cpaths
    hs1, hs2 = spectra(cct)
    ee, i0_base, mus_h = matdecomp.prepare_decomposition(cct, hs1, hs2)
    tr = np.exp(-np.outer(heel.excess_path(cct),
                          heel.material.linear_atten(ee)))
    V, R, C = hc[0].shape
    err, rel, t, tp, b, o, _ = k29_case(
        torch.stack([hc[0].reshape(-1), hc[1].reshape(-1)]),
        torch.arange(R, device=dev)[None, :, None].expand(V, R, C)
        .reshape(-1), f32(i0_base[None] * tr[:, None]), f32(mus_h), 50)
    report(records, "gauss_newton_grouped", err, t, tp, rel <= 1e-4, (b, o),
           extra=f" (heel, {R} rows of {V * C} rays; rel {rel:.3g})",
           record=False)


def afterglow_work(x):
    """K36's or K37's (bytes, float32 operations) on counts ``x``: one read
    and one write of each element; per element and trap the state update
    (3) and its term of the trap sum (2), and 1 more per element (the
    prompt or the gain)."""
    k = len(AFTERGLOW_FRACTIONS)
    return 2 * nbytes(x), x.numel() * (5 * k + 1)


def afterglow_kernel_phase(cfg, cone_cfg, spectra, records, dev):
    """Phase 3, the afterglow pair: K36 (apply) and K37 (correct) against
    their plain twins (a loop over views) on the realistic path's two
    acquisitions' bowtie counts [1000, 800] at the reference protocol and
    on the cone config's 80 kV counts [360, 16, 256], with the realistic
    path's two traps and warm start; apply then correct must round-trip.
    K36's yardstick: the same lag model with a cold start as one causal
    FFT convolution along the views with ``lag_impulse_response(n=V)``
    (K37 has none)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import afterglow as ag
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.ops.conebeam import cone_material_paths
    from dexct_tpu_torch.pipeline.api import get_sino

    a = list(AFTERGLOW_FRACTIONS)
    b = ag.decay_per_view(AFTERGLOW_TAU_MS, 1.0)
    ct, ph = cfg.ct, cfg.phantom
    s1, s2, bt, paths = realism_setup(cfg, spectra, dev)
    cases = [(s.name, get_sino(ct, ph, s, device=dev, paths=paths,
                               bowtie=bt)[0]) for s in (s1, s2)]
    del paths
    cct, cph = cone_cfg.ct, cone_cfg.phantom
    cs = spectra(cct)[1]
    cpaths = cone_material_paths(cph, cct, device=dev)
    cases.append((f"cone {cs.name}", spectral.counts_from_paths(
        cpaths, torch.as_tensor(cph.materials.mu_table(cs.E),
                                dtype=torch.float32, device=dev),
        torch.as_tensor(spectral.effective_fluence(cs, cct),
                        dtype=torch.float32, device=dev))))
    del cpaths
    torch.cuda.empty_cache()
    for i, (label, x) in enumerate(cases):
        shape = "x".join(map(str, x.shape))
        m, want, ms, pms = compare(
            lambda: ag.apply_afterglow(x, a, b, warm_start=True),
            lambda: ag.apply_afterglow_plain(x, a, b, warm_start=True), 50, 1)
        back, want_b, ms_c, pms_c = compare(
            lambda: ag.correct_afterglow(m, a, b, warm_start=True),
            lambda: ag.correct_afterglow_plain(m, a, b, warm_start=True), 50,
            1)
        trip = float((back - x).abs().max() / x.abs().max())
        med = float(((back - x).abs() / x.abs().clamp_min(1e-30)).median())
        lib = None
        extra_lib = ""
        if i == 0:
            # the yardstick: a cold start, one causal FFT convolution
            V = x.shape[0]
            h = torch.as_tensor(ag.lag_impulse_response(a, b, n=V),
                                dtype=x.dtype, device=dev)

            def fft_conv():
                n = 2 * V
                spec = torch.fft.rfft(x, n=n, dim=0) * torch.fft.rfft(
                    h, n=n)[:, None]
                return torch.fft.irfft(spec, n=n, dim=0)[:V]

            cold = ag.apply_afterglow(x, a, b)
            conv = fft_conv()
            lib = time_ms(fft_conv, 20)
            cold_ms = time_ms(lambda: ag.apply_afterglow(x, a, b), 50)
            conv_err = float((conv - cold).abs().max() / cold.abs().max())
            extra_lib = (f"; cold start {cold_ms:.4f} ms, the FFT "
                         f"convolution within {conv_err:.3g} of its max")
            if not conv_err <= 1e-4:
                fail("the FFT convolution misses K36's cold start")
        for name, got, ref, t, tp, lib_ms in (
                ("afterglow_apply", m, want, ms, pms, lib),
                ("afterglow_correct", back, want_b, ms_c, pms_c, None)):
            err, big = max_err(got, ref)
            bitwise = torch.equal(got, ref)
            report(records, name, err, t, tp, err <= 1e-6 * big,
                   afterglow_work(x), library_ms=lib_ms,
                   extra=f" ({label} [{shape}], warm start; bitwise "
                   f"{bitwise}; max |plain| {big:.4g}"
                   + (extra_lib if lib_ms is not None else "")
                   + (f"; round trip {trip:.3g} of the max, median rel "
                      f"{med:.3g}" if name == "afterglow_correct" else "")
                   + ")", record=i == 0)
        if not trip <= 1e-5:
            fail(f"afterglow apply then correct misses the {label} counts "
                 f"by {trip:.3g} of their maximum")
    del cases
    torch.cuda.empty_cache()


def gather_kernel_phase(records, dev):
    """Phase 3, the gather-rate probe: K38 (table staged in shared memory)
    and K39 (direct gather) on the JAX tool's case, an 800-entry float32
    table at 2^20 and 2^24 indices (recorded at 2^24), and K39 on the
    512^2 int32 label table at 2^24, each bit for bit against its plain
    twin ``tab[idx]``, beside ``torch.index_select``."""
    import torch

    from dexct_tpu_torch.tools import bench_gather as bg

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(GATHER_TABLE, generator=gen, device=dev)
    labels = torch.randint(0, 6, (512 * 512,), generator=gen, device=dev,
                           dtype=torch.int32)
    cases = []
    for n_log2 in GATHER_N_LOG2:
        idx = torch.randint(0, GATHER_TABLE, (1 << n_log2,), generator=gen,
                            device=dev, dtype=torch.int32)
        for name in GATHER_KERNELS:
            cases.append((name, table, idx, f"{GATHER_TABLE} float32, "
                          f"2^{n_log2}", n_log2 == GATHER_N_LOG2[-1]))
    big = torch.randint(0, 512 * 512, (1 << 24,), generator=gen, device=dev,
                        dtype=torch.int32)
    cases.append(("gather_take", labels, big, "512^2 int32 labels, 2^24",
                  False))
    for name, tab, idx, label, record in cases:
        fn = getattr(bg, name)
        got, want, ms, pms = compare(lambda: fn(tab, idx),
                                     lambda: bg.gather_plain(tab, idx), 20)
        lib = time_ms(lambda: torch.index_select(tab, 0, idx), 20)
        bitwise = torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max())
        gb_s = nbytes(tab, idx, got) / (ms * 1e-3) / 1e9
        report(records, name, err, ms, pms, bitwise,
               (nbytes(tab, idx, got), 0), library_ms=lib,
               extra=f" ({label}; bitwise {bitwise}; {gb_s:.1f} GB/s)",
               record=record)
    del cases, big
    torch.cuda.empty_cache()


def timed_stages(stages, t):
    """``stages`` with each apply and correct timed into ``t`` [ms] (host
    clock between synchronises); each afterglow stage must launch its
    kernel (K36 to apply, K37 to correct) exactly once."""
    import torch

    from dexct_tpu_torch.pipeline.realism import Stage

    from dexct_tpu_torch.ops import afterglow as ag

    def timed(fn, key):
        if fn is None:
            return None

        def run(c):
            n0 = (ag.apply_afterglow.launches, ag.correct_afterglow.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(c)
            torch.cuda.synchronize()
            t[key] = t.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            n = (ag.apply_afterglow.launches - n0[0],
                 ag.correct_afterglow.launches - n0[1])
            if key.startswith("afterglow") and n != ((1, 0) if key.endswith(
                    "apply") else (0, 1)):
                fail(f"the {key} stage launched K36, K37 {n} times, not "
                     "one launch of its kernel")
            return out
        return run

    return [Stage(st.name, timed(st.apply, f"{st.name} apply"),
                  timed(st.correct, f"{st.name} correct")) for st in stages]


def realism_chain(ct, spec, bt, dev, full=True):
    """The JAX tests' five-stage chain (tests/test_realism_chain.py:36-48:
    MTF, scatter, pileup, gains, afterglow) under the bowtie: the scatter
    and gain calibrations read the bowtie's per-channel air scan; with
    ``full=False`` the MTF and gains of its bowtie test (:129-155).  The
    focal spot keeps the JAX tests' width in detector channels (0.45 cm on
    their 384 channels over the same fan, 1.4 channels): the same 0.45 cm
    on 800 channels is a 2.9-channel rect whose spectral zeros fall inside
    the band, where no Wiener restoration recovers the counts (the JAX
    test's own caveat)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops.afterglow import decay_per_view
    from dexct_tpu_torch.ops.bowtie import bowtie_fluence
    from dexct_tpu_torch.ops.mtf import focal_spot_kernel
    from dexct_tpu_torch.ops.rings import sample_channel_gains
    from dexct_tpu_torch.ops.scatter import scatter_kernel
    from dexct_tpu_torch.pipeline import realism

    air_ch = torch.as_tensor(bowtie_fluence(spec, ct, bt).sum(-1),
                             dtype=torch.float32, device=dev)
    air = float(air_ch.max())
    spot_cm = 0.45 * 384 / ct.N_channels
    mtf = realism.stage_mtf(focal_spot_kernel(ct, spot_cm), nsr=1e-6)
    gains = realism.stage_gains(
        sample_channel_gains(3, ct.N_channels, sigma=0.01, device=dev),
        air_ch)
    if not full:
        return [mtf, gains]
    return [mtf,
            realism.stage_scatter(air_ch, scatter_kernel(ct.N_channels,
                                                         sigma_ch=60.0),
                                  spr=0.3),
            realism.stage_pileup(0.2 / air), gains,
            realism.stage_afterglow([0.05, 0.02],
                                    decay_per_view([2.0, 20.0], 1.0))]


def realistic_path(cfg, spectra, records, smi, dev):
    """Phase 4, the scanner-realism chain through the library at the
    reference protocol: ``simulate_dect_realistic`` with the JAX study's
    bowtie (31 levels) and the five-stage chain on both acquisitions, once
    with no noise and once with compound noise, twice, each stage timed,
    with the launch counters checked.  Checks: the chain's round trip on
    the clean counts (median relative error below 5e-3); the bowtie run's
    tissue sinogram under the MTF + gains chain against the clean
    no-bowtie ``simulate_dect`` (median relative error < 0.01, max < 0.1
    over rays above 0.25 x max); K29's grouped solve of the bowtie counts
    at least 4x closer in max error to the no-bowtie basis sinogram than
    K3's central-spectrum solve (through-object rays); the noiseless
    images' air ROI within 50 HU of -1000, the bladder (water) within
    BODY_TOL_HU of 0 HU after the bowtie-aware water calibration
    (``fit_water_bhc_bowtie``; uncorrected, the bowtie's channel-dependent
    hardening moves it by tens to hundreds of HU) and its tissue density
    within 5 % of the clean pipeline's; all outputs finite."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.ops.bhc import fit_water_bhc_bowtie
    from dexct_tpu_torch.ops.bowtie import decompose_sinograms_bowtie
    from dexct_tpu_torch.pipeline.api import (get_recon, get_sino,
                                              simulate_dect)
    from dexct_tpu_torch.pipeline.realism import (apply_chain,
                                                  correct_chain,
                                                  simulate_dect_realistic)

    ct, ph = cfg.ct, cfg.phantom
    s1, s2, bt, paths = realism_setup(cfg, spectra, dev)
    img = (cfg.N_matrix, cfg.FOV, cfg.ramp)
    clean = simulate_dect(ct, ph, s1, s2, *img, device=dev, n_iters=50)
    fns = zero_counters()
    for run in (1, 2):
        for noise in ("none", "compound"):
            t = {}
            gen = torch.Generator(device=dev).manual_seed(run)
            w0 = time.perf_counter()
            res = simulate_dect_realistic(
                ct, ph, s1, s2, *img,
                timed_stages(realism_chain(ct, s1, bt, dev), t),
                timed_stages(realism_chain(ct, s2, bt, dev), t),
                n_iters=50, noise=noise, generator=gen, bowtie=bt,
                device=dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            chain = sum(t.values())
            print(f"realistic path (library, run {run}, noise {noise}): "
                  f"{wall / 1e3:.3f} s on {smi}; chain stages (ms, both "
                  f"acquisitions): " + ", ".join(f"{k} {v:.1f}"
                                                 for k, v in t.items())
                  + f"; trace, counts, decomposition and FBP "
                  f"{wall - chain:.1f}")
            if noise == "none":
                quiet = res
            if not all(bool(torch.isfinite(x).all()) for pair in (
                    res.sino_log, res.mat_sinos, res.recon_HU,
                    res.mat_recons) for x in pair):
                fail(f"the realistic path ({noise}) gives non-finite "
                     "values")
    check_launches("realistic", fns, REALISTIC_KERNELS, records)
    print_profiled("realistic (no noise)", lambda: simulate_dect_realistic(
        ct, ph, s1, s2, *img, realism_chain(ct, s1, bt, dev),
        realism_chain(ct, s2, bt, dev), n_iters=50, bowtie=bt, device=dev))

    # the chain's round trip on the clean bowtie counts
    c1, _ = get_sino(ct, ph, s1, device=dev, paths=paths, bowtie=bt)
    stages = realism_chain(ct, s1, bt, dev)
    meas = apply_chain(c1, stages)
    back = correct_chain(meas, stages)
    dist = float((meas / c1 - 1.0).abs().max())
    rel = (back / c1 - 1.0).abs()
    med = float(rel.median())
    print(f"  chain round trip: the chain moves counts by up to {dist:.4f};"
          f" corrected back to median rel {med:.3g} (max "
          f"{float(rel.max()):.3g})")
    if not (dist > 0.05 and med < 5e-3):
        fail("the realism chain does not round-trip the clean counts")

    # bowtie under MTF + gains against the clean no-bowtie pipeline
    ref = clean.mat_sinos[0]
    res = simulate_dect_realistic(
        ct, ph, s1, s2, *img, realism_chain(ct, s1, bt, dev, full=False),
        realism_chain(ct, s2, bt, dev, full=False), n_iters=50,
        do_recon=False, bowtie=bt, device=dev)
    inside = ref > 0.25 * ref.max()
    rel = (res.mat_sinos[0] - ref).abs()[inside] / ref.max()
    print(f"  bowtie + MTF + gains tissue sinogram vs the clean no-bowtie "
          f"one: median rel {float(rel.median()):.3g}, max "
          f"{float(rel.max()):.3g} over {int(inside.sum())} rays")
    if not (float(rel.median()) < 0.01 and float(rel.max()) < 0.1):
        fail("the bowtie realism run misses the clean basis sinogram")

    # grouped (K29) against the central-spectrum solve (K3)
    c2, _ = get_sino(ct, ph, s2, device=dev, paths=paths, bowtie=bt)
    grouped, _ = decompose_sinograms_bowtie(ct, c1, c2, s1, s2, bt,
                                            n_iters=50)
    naive, _ = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=50)
    sel = ref > 0.1 * ref.max()
    e_g = float((grouped - ref).abs()[sel].max())
    e_n = float((naive - ref).abs()[sel].max())
    print(f"  tissue sinogram max error: grouped (K29) {e_g:.4g}, central "
          f"spectrum (K3) {e_n:.4g} g/cm^2 ({e_n / max(e_g, 1e-30):.1f}x)")
    if not e_n >= 4.0 * e_g:
        fail("the grouped solve does not beat the central-spectrum solve "
             "by 4x")

    # the noiseless realistic images: air, and the bladder (water) after
    # the bowtie-aware water calibration (WaterBhcBowtie), and its tissue
    # density against the clean pipeline's
    fov = cfg.FOV
    air = [roi_mean(h[None].cpu().numpy(), 0.0, -20.0, 0, fov)
           for h in quiet.recon_HU]
    blad = [roi_mean(h[None].cpu().numpy(), *BLADDER_XY, 0, fov)
            for h in quiet.recon_HU]
    wbhc = []
    for s, log in zip((s1, s2), quiet.sino_log):
        bhc = fit_water_bhc_bowtie(s, ct, bt)
        _, hu = get_recon(bhc(log), ct, s, *img)
        wbhc.append(roi_mean(hu[None].cpu().numpy(), *BLADDER_XY, 0, fov))
    tis = [roi_mean(m[None].cpu().numpy(), *BLADDER_XY, 0, fov)
           for m in (quiet.mat_recons[0], clean.mat_recons[0])]
    off = abs(tis[0] - tis[1]) / tis[1]
    print(f"  air ROI HU at (0, -20) cm: detunedMV {air[0]:.2f}, 80kV "
          f"{air[1]:.2f}; bladder HU {blad[0]:.2f}, {blad[1]:.2f}, after "
          f"the bowtie water BHC {wbhc[0]:.2f}, {wbhc[1]:.2f}; bladder "
          f"tissue density {tis[0]:.4f} g/cm^3 vs the clean pipeline's "
          f"{tis[1]:.4f} (off {off:.4f})")
    if not (all(abs(a + 1000.0) <= 50.0 for a in air)
            and all(abs(w) <= BODY_TOL_HU for w in wbhc) and off < 0.05):
        fail("the realistic images miss their ROI checks")


def tcm_path(cfg, spectra, records, smi, dev):
    """Phase 4, tube-current modulation through the library at the
    reference protocol: ``auto_tcm_profile`` (strength 1) then
    ``simulate_tcm_dect`` with that profile, with no noise and with
    compound noise plus an electronic floor of 1e-4 x each spectrum's air
    signal (``forward_counts(tcm=, sigma_e=)``), twice, each stage timed,
    with the launch counters checked.  The profile's mean must be 1 within
    1e-5; the noiseless log sinograms equal ``simulate_dect``'s within
    2e-6 absolute and 1e-5 of their maximum, the normalized counts within
    1e-6 relative (tests/test_tcm.py:180-197); the noisy run is finite."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops.spectral import effective_fluence
    from dexct_tpu_torch.pipeline.api import simulate_dect
    from dexct_tpu_torch.pipeline.tcm import (auto_tcm_profile,
                                              simulate_tcm_dect)

    ct, ph = cfg.ct, cfg.phantom
    s1, s2 = spectra(ct)
    img = (cfg.N_matrix, cfg.FOV, cfg.ramp)
    sig = tuple(1e-4 * float(np.sum(effective_fluence(s, ct)))
                for s in (s1, s2))
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        m = auto_tcm_profile(ct, ph, s1, device=dev)
        st.mark("auto_tcm_profile (K1, K2)")
        quiet = simulate_tcm_dect(ct, ph, s1, s2, *img, m=m, n_iters=50,
                                  device=dev)
        st.mark("simulate_tcm_dect, no noise")
        gen = torch.Generator(device=dev).manual_seed(run)
        noisy = simulate_tcm_dect(ct, ph, s1, s2, *img, m=m, n_iters=50,
                                  noise="compound", generator=gen,
                                  sigma_e=sig, device=dev)
        st.mark("simulate_tcm_dect, compound noise")
        print(f"tcm path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("tcm", fns, TCM_KERNELS, records)
    gen = torch.Generator(device=dev).manual_seed(3)
    print_profiled("tcm (compound)", lambda: simulate_tcm_dect(
        ct, ph, s1, s2, *img, m=m, n_iters=50, noise="compound",
        generator=gen, sigma_e=sig, device=dev))
    ref = simulate_dect(ct, ph, s1, s2, *img, device=dev, n_iters=50,
                        do_recon=False)
    d_log = max(float((q - r).abs().max())
                for q, r in zip(quiet.sino_log, ref.sino_log))
    norm = d_log / max(float(r.abs().max()) for r in ref.sino_log)
    d_raw = max(float(((q - r).abs() / r.abs().clamp_min(1e-30)).max())
                for q, r in zip(quiet.sino_raw, ref.sino_raw))
    finite = all(bool(torch.isfinite(x).all()) for pair in (
        noisy.sino_log, noisy.mat_sinos, noisy.recon_HU, noisy.mat_recons)
        for x in pair)
    print(f"  profile mean {float(m.mean()):.7f}, range "
          f"[{float(m.min()):.3f}, {float(m.max()):.3f}]; noiseless vs "
          f"simulate_dect: log sinograms max abs {d_log:.3g} ({norm:.3g} of "
          f"their max), normalized counts max rel {d_raw:.3g}; compound "
          f"run finite: {finite}")
    # the JAX test's bars (tests/test_tcm.py:180-197): log atol 2e-6,
    # normalized counts rtol 1e-6
    if not (abs(float(m.mean()) - 1.0) <= 1e-5 and d_log <= 2e-6
            and norm <= 1e-5 and d_raw <= 1e-6 and finite):
        fail("the tcm path misses its checks")


def heel_path(ccfg, spectra, records, smi, dev):
    """Phase 4, the anode heel through the library on the cone config:
    ``simulate_cone_dect(heel=HeelEffect(d0_cm=HEEL_D0_CM))``, twice,
    timed, with the launch counters checked.  Then ``d0_cm = 0`` must be
    bitwise the heel-free result, and the row-grouped decomposition's
    max error against the heel-free basis sinogram below 0.2 x that of
    K3's central-spectrum solve of the heel counts (through-object
    rays)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect
    from dexct_tpu_torch.ops.heel import HeelEffect

    ct, ph = ccfg.ct, ccfg.phantom
    s1, s2 = spectra(ct)
    img = (ccfg.N_matrix, ccfg.FOV, ccfg.ramp)
    heel = HeelEffect(d0_cm=HEEL_D0_CM)
    fns = zero_counters()
    for run in (1, 2):
        w0 = time.perf_counter()
        res = simulate_cone_dect(ct, ph, s1, s2, *img, device=dev,
                                 n_iters=50, heel=heel)
        torch.cuda.synchronize()
        print(f"heel path (library, run {run}): "
              f"{time.perf_counter() - w0:.3f} s on {smi}")
    check_launches("heel", fns, HEEL_KERNELS, records)
    print_profiled("heel", lambda: simulate_cone_dect(
        ct, ph, s1, s2, *img, device=dev, n_iters=50, heel=heel))
    free = simulate_cone_dect(ct, ph, s1, s2, *img, device=dev, n_iters=50)
    zero = simulate_cone_dect(ct, ph, s1, s2, *img, device=dev, n_iters=50,
                              heel=HeelEffect(d0_cm=0.0))
    same = all(torch.equal(a, b) for k in free for a, b in
               zip(free[k], zero[k]))
    c1, c2 = res["sino_raw"]
    _, i0, mus = matdecomp.prepare_decomposition(ct, s1, s2)
    naive = matdecomp.gauss_newton_solve(
        torch.stack([c1.reshape(-1), c2.reshape(-1)]),
        torch.as_tensor(i0, dtype=torch.float32, device=dev),
        torch.as_tensor(mus, dtype=torch.float32, device=dev),
        n_iters=50)[:, 0].reshape(c1.shape)
    truth = free["mat_sinos"][0]
    sel = truth > 0.1 * truth.max()
    e_a = float((res["mat_sinos"][0] - truth).abs()[sel].max())
    e_n = float((naive - truth).abs()[sel].max())
    finite = all(bool(torch.isfinite(x).all()) for k in res
                 for x in res[k])
    print(f"  d0_cm = 0 bitwise the heel-free result: {same}; tissue "
          f"sinogram max error vs heel-free: row-grouped (K29) {e_a:.4g}, "
          f"central spectrum (K3) {e_n:.4g} g/cm^2 (ratio "
          f"{e_a / max(e_n, 1e-30):.3f}); finite: {finite}")
    if not (same and e_a < 0.2 * e_n and finite):
        fail("the heel path misses its checks")


def motion_scan(cfg, spectra, track, dev, static=False):
    """The reference protocol's scan of the moving pelvis (or, ``static``,
    of the still one): exact paths on the object-frame rays (K1), both
    acquisitions' counts and logs (K2) and their decomposition (K3, 50
    iterations).  Returns (c1, c2, [log1, log2, tissue, bone])."""
    from dexct_tpu_torch.ops import matdecomp, motion, siddon, spectral

    ct, ph = cfg.ct, cfg.phantom
    s1, s2 = spectra(ct)
    paths = (siddon.material_path_sinogram(ph, ct, device=dev) if static
             else motion.material_path_sinogram_motion(ph, ct, track,
                                                       device=dev))
    (c1, l1), (c2, l2) = (spectral.forward_counts(paths, ph, s, ct)
                          for s in (s1, s2))
    m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=50)
    return c1, c2, [l1, l2, m1, m2]


def gated_scan(cfg, dev):
    """The gated path's scan: the port's thorax at 256^2 (0.2 cm) under
    the reference fan over GATED_TURNS turns, AP breathing with
    GATED_CYCLES cycles over the scan, monoenergetic at GATED_KEV (K1).
    Returns (geometry, the breathing period in views, phantom, log
    sinogram, mu)."""
    import dataclasses

    import numpy as np

    from dexct_tpu_torch.ops import motion
    from dexct_tpu_torch.ops.siddon import mono_sinogram
    from dexct_tpu_torch.pipeline.gated import view_phases
    from dexct_tpu_torch.system.phantom import thorax_phantom

    ph = thorax_phantom(N=256, dx=0.2)
    ct = dataclasses.replace(
        cfg.ct, N_proj=GATED_TURNS * cfg.ct.N_proj,
        rotation_total=GATED_TURNS * cfg.ct.rotation_total)
    period = ct.N_proj / GATED_CYCLES
    ph_v = view_phases(ct.N_proj, period)
    disp = GATED_AMP_CM * np.sin(2.0 * np.pi * ph_v)[:, None] \
        * np.array([[0.0, 1.0]])
    track = motion.MotionProfile(np.zeros(ct.N_proj), disp)
    mu = ph.materials.mu_table(np.array([GATED_KEV]))[:, 0]
    sino = mono_sinogram(motion.material_path_sinogram_motion(
        ph, ct, track, device=dev), mu)
    return ct, period, ph, sino, mu


def motion_3d_stack(ccfg, spectra, track, dev):
    """One motion_3d scan: the exact cone paths of the moving pelvis (K10),
    both acquisitions (K2) and their decomposition (K3, 50 iterations),
    stacked [log1, log2, tissue, bone] as [4, V, R, C]."""
    import torch

    from dexct_tpu_torch.ops import matdecomp, motion, spectral

    ct, ph = ccfg.ct, ccfg.phantom
    s1, s2 = spectra(ct)
    paths = motion.cone_material_paths_motion(ph, ct, track, device=dev)
    (c1, l1), (c2, l2) = (spectral.forward_counts(paths, ph, s, ct)
                          for s in (s1, s2))
    m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=50)
    return torch.stack([l1, l2, m1, m2])


def covered_by_every_view(betas, ct, n, fov):
    """[N, N] mask of the pixels inside every view's fan (K4's channel
    test), and its count."""
    import torch

    from dexct_tpu_torch.ops.fbp_fast import _pixel_coords

    X, Y = _pixel_coords(n, fov, torch.float32, betas.device)
    count = torch.zeros_like(X, dtype=torch.int64)
    C = ct.N_channels
    for v0 in range(0, betas.shape[0], 50):
        b = betas[v0:v0 + 50, None]
        vr = X[None] * torch.cos(b) + Y[None] * torch.sin(b) - ct.SID
        vt = -X[None] * torch.sin(b) + Y[None] * torch.cos(b)
        c = torch.atan2(-vt, -vr) / ct.dgamma - 0.5 + C / 2.0
        count += ((c >= 0) & (c <= C - 1)).sum(0)
    mask = (count == betas.shape[0]).reshape(n, n)
    return mask, int(mask.sum())


def motion_kernel_phase(cfg, cone_cfgs, spectra, records, dev):
    """Phase 3, K30-K33 against their plain versions on the inputs their
    paths give them.  K30: the motion path's filtered 80 kV log sinogram
    (1000 x 800, the breathing pelvis) and true track -> 512^2, and at zero
    pose bitwise against K4 on the same sinogram.  K31: the gated path's
    filtered thorax sinogram (4000 x 800) with its four gates in one
    launch, and all-ones weights over the first turn against K4 where
    every view's fan covers the pixel.  K32: the cone config's filtered
    [log1, log2, tissue, bone] stack of the z-breathing pelvis (360 x 16 x
    256 -> 16 x 256^2).  K33: the helical config's stack under a 1.6 cm z
    drift (720 x 16 x 256 -> 19 x 256^2).  Bounds from this run's terms:
    K30 25 + 6 (pose) + 4 (tap) operations per pixel-view; K31 25 + 4 per
    gate per pixel-view with any nonzero weight; K32 and K33 from the work
    that the plain version counts on this run's track: MOTION_PLANE_OPS per
    (disc pixel, view) whose in-plane geometry some slice takes,
    MOTION_ROW_OPS per (pixel, slice, view) row evaluated (K33: inside the
    slice's moving window), MOTION_TAP_OPS + 7 per image for each row on
    the detector inside the fan (the per-(slice, view) z and window terms,
    nz V of them, are left out)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, fbp_fast, motion
    from dexct_tpu_torch.ops.fbp import filter_sinogram
    from dexct_tpu_torch.pipeline import gated

    ct, n, fov = cfg.ct, cfg.N_matrix, cfg.FOV
    V, C = ct.N_proj, ct.N_channels
    track = motion.MotionProfile.breathing(V, **MOTION_TRACK)
    _, _, sinos = motion_scan(cfg, spectra, track, dev)
    q = filter_sinogram(sinos[1], ct).contiguous()
    betas = torch.as_tensor(ct.betas, dtype=torch.float32, device=dev)
    dbeta = float(ct.rotation_total) / V
    args = (q, betas, ct.SID, ct.dgamma, n, fov, track.phi, track.disp)
    img, want, ms, pms = compare(
        lambda: motion.fan_backproject_motion(*args, dbeta=dbeta),
        lambda: motion.fan_backproject_motion_plain(*args, dbeta), reps=3)
    err, big = max_err(img, want)
    report(records, "fan_backproject_motion", err, ms, pms, err <= 1e-5 * big,
           (nbytes(q, img) + 24 * V, n * n * V * (25 + 6 + 4)),
           extra=f" (max |plain| {big:.6g} cm^-1)")
    still = motion.fan_backproject_motion(
        q, betas, ct.SID, ct.dgamma, n, fov, np.zeros(V), np.zeros((V, 2)),
        dbeta=dbeta)
    k4 = fbp_fast.fan_backproject_multi(fbp_fast.pack_filtered(q[None]), 1,
                                        betas, ct.SID, ct.dgamma, C, n, fov,
                                        dbeta)[0]
    same = torch.equal(still, k4)
    print(f"  fan_backproject_motion at zero pose bitwise equal to K4: "
          f"{same}")
    if not same:
        fail("K30 at zero pose differs from K4")
    del sinos, q

    gct, period, _, gsino, _ = gated_scan(cfg, dev)
    q = filter_sinogram(gsino, gct).contiguous()
    gbetas = torch.as_tensor(gct.betas, dtype=torch.float32, device=dev)
    ph_v = gated.view_phases(gct.N_proj, period)
    w = torch.as_tensor(np.stack([gated.gate_weights(ph_v, g / GATED_GATES,
                                                     0.3)
                                  for g in range(GATED_GATES)]),
                        dtype=torch.float32, device=dev)
    gargs = (q, gbetas, w, gct.SID, gct.dgamma, n, fov)
    frames, want, ms, pms = compare(
        lambda: gated._gated_backproject(*gargs),
        lambda: gated._gated_backproject_plain(*gargs), reps=2)
    err, big = max_err(frames, want)
    live = int((w != 0).any(0).sum())
    report(records, "gated_backproject", err, ms, pms, err <= 1e-5 * big,
           (nbytes(q, gbetas, w, frames), n * n * live * (25 + 4 * GATED_GATES)),
           extra=f" ({GATED_GATES} gates x {gct.N_proj} views, {live} with "
                 f"a nonzero weight; max |plain| {big:.6g} cm^-1)")
    q1, b1 = q[:V].contiguous(), gbetas[:V]
    ones = gated._gated_backproject(q1, b1, torch.ones(V, device=dev),
                                    gct.SID, gct.dgamma, n, fov)
    k4 = fbp_fast.fan_backproject_multi(fbp_fast.pack_filtered(q1[None]), 1,
                                        b1, gct.SID, gct.dgamma, C, n, fov,
                                        2.0 * np.pi / V)[0]
    mask, n_cov = covered_by_every_view(b1, gct, n, fov)
    err = float((ones - k4).abs()[mask].max())
    big = float(k4.abs()[mask].max())
    print(f"  gated_backproject all-ones over one turn vs K4 on the {n_cov} "
          f"pixels every view's fan covers: max abs {err:.3g} (max "
          f"{big:.4g}) [<= 1e-5 x max]")
    if not err <= 1e-5 * big:
        fail("K31 with all-ones weights differs from K4")
    del gsino, q, q1

    for label, dz_cm in (("cone", CONE_DZ_CM), ("helical", HELICAL_DZ_CM)):
        ccfg = cone_cfgs[label]
        cct = ccfg.ct
        V3, R = cct.N_proj, cct.N_rows
        track3 = motion.MotionProfile3D.breathing_z(V3, amplitude_cm=dz_cm)
        stack = motion_3d_stack(ccfg, spectra, track3, dev)
        qs, _ = motion._cone_filtered(stack, cct, ccfg.ramp, "sinc", None)
        del stack
        b3 = torch.as_tensor(cct.betas, dtype=torch.float32, device=dev)
        n3, fov3 = ccfg.N_matrix, ccfg.FOV
        X, Y, _ = conebeam._disc(n3, fov3, dev)
        geo = (cct.SID, cct.dgamma, cct.h_iso)
        if label == "cone":
            nz, dz = R, cct.h_iso
            z0 = (0.5 - nz / 2.0) * dz
            grid = (n3, nz, fov3, dz, z0)
            kern = lambda: motion._fdk_backproject_motion(  # noqa: E731
                qs, b3, track3.phi, track3.disp, *geo, R, *grid)
            window, name = None, "fdk_backproject_motion"
        else:
            z_out, dz = conebeam.helical_slices(cct)
            nz, z0 = len(z_out), z_out[0]
            grid = (n3, nz, fov3, dz, z0)
            window = (np.asarray(cct.source_z), 0.5 * cct.rotation_total,
                      cct.pitch)
            kern = lambda: motion._helical_backproject_motion(  # noqa: E731
                qs, b3, window[0], window[1], track3.phi, track3.disp, *geo,
                R, cct.pitch, *grid)
            name = "helical_backproject_motion"
        plain = lambda **kw: motion._motion_backproject_plain(  # noqa: E731
            qs, b3, track3.phi, track3.disp, *geo, *grid, 8, window=window,
            **kw)
        vol, want, ms, pms = compare(kern, plain, reps=1)
        err, big = max_err(vol, want)
        work = {}
        plain(terms=work)
        K = qs.shape[0]
        report(records, name, err, ms, pms, err <= 1e-4 * big,
               (nbytes(qs, vol) + 16 * X.shape[0] + 32 * V3,
                MOTION_PLANE_OPS * work["pixel_views"]
                + MOTION_ROW_OPS * work["terms"]
                + (MOTION_TAP_OPS + 7 * K) * work["taps"]),
               extra=f" ({label} config, {dz_cm} cm z drift, {nz} slices; "
                     f"{work['pixel_views']} pixel-views, {work['terms']} "
                     f"pixel-slice-views evaluated, {work['taps']} with "
                     f"taps; max |plain| {big:.6g})")
        del qs, vol, want
        torch.cuda.empty_cache()


def motion_path(cfg, spectra, records, smi, dev):
    """Phase 4, rigid patient motion through the library at the reference
    protocol, twice, with the launch counters checked: the breathing
    pelvis's exact scan (``material_path_sinogram_motion``, K1), counts
    (K2), decomposition (K3), ``fbp_recon_motion`` of both log and both
    basis sinograms with the true track (K30), ``estimate_translation``,
    ``estimate_motion_joint`` (its defaults: 800 Adam iterations, n_theta
    512; K7 and K21) and ``onestep_spectral_recon(motion=)`` from the
    compensated basis images (300 iterations).  Checks: finite outputs;
    air ~ -1000 HU in the compensated 80 kV image; each compensated image's
    rms error against the static scan's image at least MOTION_RATIO_REF
    times below the uncorrected FBP's; the centroid and joint tracks' errors
    within MOTION_TRACK_REF's bands of the JAX package's, the joint one
    below the centroid one; the one-step data loss below its start's."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import fbp, fourier, motion, onestep
    from dexct_tpu_torch.ops.matdecomp import (DEFAULT_BASIS,
                                               prepare_decomposition)
    from dexct_tpu_torch.pipeline.api import effective_water_mu

    ct, n, fov = cfg.ct, cfg.N_matrix, cfg.FOV
    s1, s2 = spectra(ct)
    vs = (ct.N_proj, ct.N_channels)
    track = motion.MotionProfile.breathing(ct.N_proj, **MOTION_TRACK)
    ee, i0s, _ = prepare_decomposition(ct, s1, s2)
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        c1, c2, sinos = motion_scan(cfg, spectra, track, dev)
        st.mark("scan: trace, counts, decomposition (K1, K2, K3)")
        mc = [motion.fbp_recon_motion(s, ct, n, fov, track)[0]
              for s in sinos]
        st.mark("fbp_recon_motion x 4 (K30)")
        est0, _ = motion.estimate_translation(sinos[1], ct)
        st.mark("estimate_translation (host)")
        est, ximg = motion.estimate_motion_joint(sinos[1], ct, n, fov,
                                                 init=est0)
        st.mark("estimate_motion_joint, 800 iterations (K7, K21)")
        plan = fourier.plan_fourier_projector(recon_grid(cfg), ct,
                                              device=dev)
        st.mark(f"Fourier plan of the {n}^2 grid (host)")
        x0 = torch.clamp_min(torch.stack(mc[2:]), 0.0)
        x = onestep.onestep_spectral_recon(
            torch.stack([c1, c2]), ee, i0s, DEFAULT_BASIS, plan, vs, x0=x0,
            motion=track, geometry=ct)
        st.mark("onestep_spectral_recon(motion=), 300 iterations "
                "(K7, K21)")
        print(f"motion path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("motion", fns, MOTION_KERNELS, records)
    print_profiled("motion joint estimator (20 iterations)",
                   lambda: motion.estimate_motion_joint(
                       sinos[1], ct, n, fov, init=est0, n_iters=20))
    outs = mc + [ximg, x, *sinos]
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    hu = fbp.hu_image(mc[1], effective_water_mu(s2, ct))
    air = roi_mean(hu[None].cpu().numpy(), 0.0, -20.0, 0, fov)
    _, _, still = motion_scan(cfg, spectra, track, dev, static=True)
    ratios = []
    for s_mov, s_still, fix in zip(sinos, still, mc):
        ref = fbp.fbp_recon(s_still, ct, n, fov)[0]
        bad = fbp.fbp_recon(s_mov, ct, n, fov)[0]
        e_bad = float(torch.sqrt(torch.mean((bad - ref) ** 2)))
        e_fix = float(torch.sqrt(torch.mean((fix - ref) ** 2)))
        ratios.append(e_bad / e_fix)
    amp = float(np.sqrt(np.mean(track.disp ** 2)))
    errs = [float(np.sqrt(np.mean((e.disp - track.disp) ** 2))) / amp
            for e in (est0, est)]
    mus = torch.as_tensor(np.stack([b.mass_atten(ee) for b in
                                    DEFAULT_BASIS]), dtype=torch.float32,
                          device=dev)
    data = onestep._objective(
        lambda im, m, i: onestep.spectral_forward_images(
            plan, im, m, i, vs,
            disp=torch.as_tensor(track.disp, dtype=torch.float32,
                                 device=dev),
            resample_meta=motion.fan_line_coords(ct, dev)),
        torch.stack([c1, c2]), mus,
        torch.as_tensor(i0s, dtype=torch.float32, device=dev), 0.0, 1e-2)
    with torch.no_grad():
        loss0, loss = float(data(x0)), float(data(x))
    print(f"  air ROI HU at (0, -20) cm of the compensated 80 kV image: "
          f"{air:.2f}; uncorrected / compensated rms error against the "
          f"static image (log detunedMV, log 80kV, tissue, bone): "
          + ", ".join(f"{r:.4f}" for r in ratios)
          + f" [>= {MOTION_RATIO_REF}, the JAX package's at half "
          f"resolution]; track err/amp centroid {errs[0]:.4f}, joint "
          f"{errs[1]:.4f} [JAX's at half resolution "
          + ", ".join(f"{r} +- {t}" for r, t in MOTION_TRACK_REF)
          + f"]; one-step normalized data loss {loss0:.6g} -> {loss:.6g}; "
          f"finite: {finite}")
    tracks_ok = all(abs(e - r) <= t
                    for e, (r, t) in zip(errs, MOTION_TRACK_REF))
    if not (finite and abs(air + 1000.0) <= AIR_TOL_HU
            and min(ratios) >= MOTION_RATIO_REF and tracks_ok
            and errs[1] < errs[0] and loss < loss0):
        fail("the motion path misses its checks")


def lung_mask(ph, n, fov):
    """The thorax's lung pixels (label 5) on the n^2 image grid over fov
    cm: each pixel centre's phantom cell."""
    import numpy as np

    c = (np.arange(n) + 0.5 - n / 2.0) * (fov / n)
    idx = np.clip(np.floor(c / ph.dx + ph.Nx / 2.0).astype(int), 0,
                  ph.Nx - 1)
    return ph.slice_labels()[np.ix_(idx, idx)] == 5


def gated_path(cfg, records, smi, dev):
    """Phase 4, gated (4-D) reconstruction through the library: the
    breathing thorax over GATED_TURNS turns of the reference fan (K1 on
    the object-frame rays), ``gated_series`` with GATED_GATES gates of
    width 0.3 (one K31 launch), twice, with the launch counters checked.
    Checks: finite frames; the frame at the pose extreme (phase 0.25)
    within GATED_FACTOR of the ungated average's rms error on the lungs,
    both against the object frozen at that pose (one turn, static FBP)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import fbp, motion
    from dexct_tpu_torch.ops.siddon import mono_sinogram
    from dexct_tpu_torch.pipeline import gated

    n, fov = cfg.N_matrix, cfg.FOV
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        gct, period, ph, sino, mu = gated_scan(cfg, dev)
        st.mark(f"scan of {gct.N_proj} views (K1)")
        frames = gated.gated_series(sino, gct, n, fov, period,
                                    n_gates=GATED_GATES, width=0.3)
        st.mark(f"gated_series, {GATED_GATES} gates (K31)")
        print(f"gated path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("gated", fns, GATED_KERNELS, records)
    print_profiled("gated (scan and series)", lambda: gated.gated_series(
        gated_scan(cfg, dev)[3], gct, n, fov, period, n_gates=GATED_GATES,
        width=0.3))
    ungated = gated.gated_fbp_recon(sino, gct, n, fov, np.ones(gct.N_proj))
    V = cfg.ct.N_proj
    frozen = motion.MotionProfile(np.zeros(V), np.broadcast_to(
        [0.0, GATED_AMP_CM], (V, 2)).copy())
    ref = fbp.fbp_recon(mono_sinogram(motion.material_path_sinogram_motion(
        ph, cfg.ct, frozen, device=dev), mu), cfg.ct, n, fov)[0]
    lung = torch.as_tensor(lung_mask(ph, n, fov), device=dev)
    e_un = float(torch.sqrt(torch.mean((ungated - ref)[lung] ** 2)))
    e_g = float(torch.sqrt(torch.mean((frames[1] - ref)[lung] ** 2)))
    finite = bool(torch.isfinite(frames).all())
    print(f"  {frames.shape[0]} frames of {n}^2; lung rms error against the "
          f"frozen pose: gate at phase 0.25 {e_g:.5g}, ungated {e_un:.5g} "
          f"(ratio {e_g / e_un:.3f}, <= {GATED_FACTOR}) on "
          f"{int(lung.sum())} lung pixels; finite: {finite}")
    if not (finite and e_g < GATED_FACTOR * e_un):
        fail("the gated path misses its checks")


def full_coverage_slices(ct, nz, dz, fov):
    """The slices of a circular scan whose every disc voxel stays on the
    detector rows for every view (one row of margin): |z| SID / (SID -
    fov/2) <= (R/2 - 1) h_iso."""
    import numpy as np

    z = (np.arange(nz) + 0.5 - nz / 2.0) * dz
    reach = np.abs(z) * ct.SID / (ct.SID - 0.5 * fov)
    return np.nonzero(reach <= (0.5 * ct.N_rows - 1.0) * ct.h_iso)[0]


def motion_3d_path(cone_cfgs, spectra, records, smi, dev):
    """Phase 4, axial patient motion through the library, twice, with the
    launch counters checked: the cone config under a CONE_DZ_CM breathing
    drift (``cone_material_paths_motion``, K10; K2; K3;
    ``fdk_reconstruct_motion`` of the four volumes, K32) and the helical
    config under a HELICAL_DZ_CM drift (the same chain and
    ``helical_fdk_reconstruct_motion``, K33).  Checks (after the counted
    runs): zero motion against the static reconstructions of the still
    scan (the cone's full-coverage slices within 1e-5 x max of K11's; the
    helix within 0.1 x max of K12 'full''s, the JAX test's bound for its
    window-edge flips); finite volumes; the 80 kV air ROI HU at (0, -18)
    cm of the central slice of each compensated volume within AIR_TOL_HU
    of -1000 (cone) or of the JAX package's HELICAL_AIR_REF (helix); each
    compensated volume's rms error against the still scan's static
    reconstruction below the uncorrected one's, and for the helix at
    least HELICAL_RATIO_REF times below it, image by image."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, motion
    from dexct_tpu_torch.ops.fbp import hu_image
    from dexct_tpu_torch.pipeline.api import effective_water_mu

    cases = []
    for label, dz_cm in (("cone", CONE_DZ_CM), ("helical", HELICAL_DZ_CM)):
        ccfg = cone_cfgs[label]
        track = motion.MotionProfile3D.breathing_z(ccfg.ct.N_proj,
                                                   amplitude_cm=dz_cm)
        helix = label == "helical"
        mc = (motion.helical_fdk_reconstruct_motion if helix
              else motion.fdk_reconstruct_motion)
        static = (conebeam.helical_fdk_reconstruct if helix
                  else conebeam.fdk_reconstruct)
        cases.append((label, ccfg, track, mc, static))
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        vols, stacks = [], []
        for label, ccfg, track, mc, _ in cases:
            stacks.append(motion_3d_stack(ccfg, spectra, track, dev))
            st.mark(f"{label} scan (K10, K2, K3)")
            vols.append(mc(stacks[-1], ccfg.ct, ccfg.N_matrix, ccfg.FOV,
                           ccfg.ramp, track))
            st.mark(f"{label} motion-compensated reconstruction")
        print(f"motion_3d path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("motion_3d", fns, MOTION_3D_KERNELS, records)
    label, ccfg, track, mc, _ = cases[1]
    print_profiled("motion_3d helical scan and reconstruction", lambda: mc(
        motion_3d_stack(ccfg, spectra, track, dev), ccfg.ct, ccfg.N_matrix,
        ccfg.FOV, ccfg.ramp, track))
    ok = True
    for (label, ccfg, track, mc, static), vol, moving in zip(cases, vols,
                                                             stacks):
        ct, n, fov = ccfg.ct, ccfg.N_matrix, ccfg.FOV
        img = (n, fov, ccfg.ramp)
        still = motion_3d_stack(ccfg, spectra,
                                motion.MotionProfile3D.static(ct.N_proj),
                                dev)
        kw = {}
        if label == "helical":
            kw = dict(z_out=conebeam.helical_slices(ct)[0],
                      weighting="full")
            sl = np.arange(vol.shape[1])
        else:
            sl = full_coverage_slices(ct, vol.shape[1], ct.h_iso, fov)
        ref = static(still, ct, *img, **kw)
        bad = static(moving, ct, *img, **kw)
        kw.pop("weighting", None)
        zero = mc(still, ct, *img, motion.MotionProfile3D.static(ct.N_proj),
                  **kw)
        big = float(ref[:, sl].abs().max())
        d0 = float((zero - ref)[:, sl].abs().max())
        tol = 0.1 if label == "helical" else 1e-5
        e_fix = [float(torch.sqrt(torch.mean((vol[k] - ref[k])[sl] ** 2)))
                 for k in range(4)]
        e_bad = [float(torch.sqrt(torch.mean((bad[k] - ref[k])[sl] ** 2)))
                 for k in range(4)]
        mid = vol.shape[1] // 2
        mu_w = effective_water_mu(spectra(ct)[1], ct)
        air = [roi_mean(hu_image(v[1], mu_w).cpu().numpy(), 0.0, -18.0, mid,
                        fov) for v in (zero, vol, bad)]
        finite = bool(torch.isfinite(vol).all())
        print(f"  {label}: zero motion vs static max abs {d0:.3g} (max "
              f"{big:.4g}) [<= {tol:g} x max] on {len(sl)} slices; rms "
              f"error compensated / uncorrected (log detunedMV, log 80kV, "
              f"tissue, bone): "
              + ", ".join(f"{f:.4g}/{b:.4g}" for f, b in zip(e_fix, e_bad))
              + f"; 80 kV air ROI HU at (0, -18) cm, slice {mid}: still "
              f"{air[0]:.2f}, compensated {air[1]:.2f}, uncorrected "
              f"{air[2]:.2f}; finite: {finite}")
        if label == "helical":
            want_air = HELICAL_AIR_REF
            least = tuple(max(1.0, r) for r in HELICAL_RATIO_REF)
        else:
            want_air, least = -1000.0, (1.0,) * 4
        print(f"    [compensated air within {AIR_TOL_HU:g} HU of "
              f"{want_air}; uncorrected / compensated rms >= "
              + ", ".join(f"{r:g}" for r in least) + "]")
        ok &= (d0 <= tol * big and abs(air[1] - want_air) <= AIR_TOL_HU
               and all(b > r * f for f, b, r in zip(e_fix, e_bad, least))
               and finite)
        del still, ref, bad, zero
        torch.cuda.empty_cache()
    if not ok:
        fail("the motion_3d path misses its checks")


def motion_devices_phase():
    """Phase 5: the tiny motion paths of ``dexct_tpu_torch.utils.
    tiny_cases`` (a breathing fan through K1-K3, K30, the estimators and
    the motion one-step fit; a gated series, K31; the z-breathing cone and
    helix, K10, K32, K33) on the CPU and on the card, each output within
    MOTION_TOL of its maximum (the card tests run the same cases)."""
    from dexct_tpu_torch.utils import tiny_cases as tc

    for kind in tc.MOTION_KINDS:
        c, g = tc.motion(kind, "cpu"), tc.motion(kind, "cuda")
        errs = [float((gi - ci).abs().max() / ci.abs().max())
                for gi, ci in zip(g, c)]
        print(f"  motion {kind}: card vs CPU max abs / max per output "
              + ", ".join(f"{e:.3g}" for e in errs)
              + f" [<= {tc.MOTION_TOL:g}]")
        if not max(errs) <= tc.MOTION_TOL:
            fail(f"tiny motion path {kind} differs between the CPU and the "
                 "card")


def pcd_setup(tmp, dev, gens):
    """The spectral paths' scenes: the reference protocol as a
    photon-counting scan (config, its 140 kV spectrum at PCD_DOSE_MGY), the
    K-edge scenes' phantoms ({scene: phantom}) and the K-edge basis."""
    from dexct_tpu_torch.physics.materials import (BONE, WATER, Material,
                                                   MaterialTable)
    from dexct_tpu_torch.pipeline.runner import _resolve_spectrum
    from dexct_tpu_torch.system import water_cylinder_phantom
    from dexct_tpu_torch.system.config import read_parameter_file

    pcfg = read_parameter_file(write_2d_params(tmp, "pcd", PCD_PARAMS))[0]
    spec = _resolve_spectrum("140kV", PCD_DOSE_MGY, pcfg.ct, str(SPECTRA),
                             gens)
    kph = {"pelvis": kedge_phantom(pcfg.phantom, "pelvis", MaterialTable,
                                   Material),
           "cylinder": kedge_phantom(water_cylinder_phantom(
               **KEDGE_CYLINDER), "cylinder", MaterialTable, Material)}
    basis = (WATER, BONE, Material("iodine", 4.93, "I(100.0)"),
             Material("gadolinium", 7.9, "Gd(100.0)"))
    return pcfg, spec, kph, basis


def newton_work(n_pix, n_meas, n_mats, n_iters, e_full, newton=False,
                polish=4, warm_nodes=32, compress=True):
    """Bytes and operations of one K35 solve (SOLVE_OPS's count): the warm
    phase on the ~warm_nodes-node table when the log warm phase compresses
    it, the polish on the full grid."""
    T = n_mats * (n_mats + 1) // 2
    e_warm = e_full
    if compress and e_full > 2 * warm_nodes and n_iters > polish:
        seg = -(-e_full // warm_nodes)
        e_warm = -(-e_full // seg)
    node = 2 * n_mats + 1 + 2 * n_meas * (1 + n_mats) \
        + (2 * n_meas * T if newton else 0)
    step = 2 * n_meas * (n_mats + T) + 8 * n_meas + SOLVE_OPS[n_mats]
    n_pol = min(polish, n_iters)
    per_pix = (n_iters - n_pol) * (node * e_warm + step) \
        + n_pol * (node * e_full + step)
    row = n_mats + n_meas * (1 + n_mats) + (n_meas * T if newton else 0)
    return (4 * n_pix * (n_meas + n_mats) + 4 * row * (e_full + e_warm),
            n_pix * per_pix)


def compare_once(kernel_fn, plain_fn, reps):
    """Kernel and plain outputs, the kernel's mean time over ``reps`` calls
    after a warm-up and the plain version's time of a single call (CUDA
    events): for plain versions too slow to repeat at full width."""
    import torch

    got = kernel_fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = plain_fn()
    end.record()
    torch.cuda.synchronize()
    return got, want, time_ms(kernel_fn, reps), start.elapsed_time(end)


def spectral_kernel_phase(cfg, pcd, spectra, records, dev):
    """Phase 3, spectral paths: K34 (the bins' counts) on the exact trace
    of the photon-counting reference protocol with the 4 bins of the
    packed path (pelvis, 6 materials) and the K-edge scan's 6 bins (8
    materials; recorded), and K35 on those counts: M = 4, K = 2 with the
    packed path's 10 iterations, M = 6, K = 4 with the K-edge scan's 60
    (recorded), and at (2, 2) on the exact path's DE counts beside K3."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp, siddon, spectral
    from dexct_tpu_torch.physics import xcom
    from dexct_tpu_torch.physics.materials import BONE, TISSUE
    from dexct_tpu_torch.utils import tiny_cases

    pcfg, spec, kph, basis4 = pcd
    ct = pcfg.ct
    cases = []
    for label, ph, thr, basis, n_iters in (
            ("packed, M = 4, K = 2", pcfg.phantom, PCD_THRESHOLDS,
             (TISSUE, BONE), 10),
            ("K-edge pelvis, M = 6, K = 4", kph["pelvis"], KEDGE_THRESHOLDS,
             basis4, 60)):
        paths = siddon.material_path_sinogram(ph, ct, device=dev)
        mu = torch.as_tensor(ph.materials.mu_table(spec.E),
                             dtype=torch.float32, device=dev)
        i0s = matdecomp.pcd_bin_fluences(ct, spec, thr)
        i0_T = torch.as_tensor(i0s.T.copy(), dtype=torch.float32,
                               device=dev)
        c, want, ms, pms = compare(
            lambda: spectral.counts_from_paths(paths, mu, i0_T),
            lambda: spectral.counts_from_paths_plain(paths, mu, i0_T),
            reps=3)
        err = float((c - want).abs().max())
        rel = float(((c - want).abs() / want.abs().clamp_min(1e-30)).max())
        n_rays, E, M = c.numel() // c.shape[-1], mu.shape[1], c.shape[-1]
        work = (nbytes(paths, mu, i0_T, c),
                n_rays * E * (2 * mu.shape[0] + 1 + 2 * M))
        report(records, "multibin_counts", err, ms, pms, rel <= 1e-5, work,
               extra=f" (max rel {rel:.3g}; {label}: {n_rays} rays, "
                     f"{mu.shape[0]} materials, {E} energies, {M} bins)",
               record=basis is basis4)
        counts = torch.movedim(c, -1, 0).reshape(M, -1).contiguous()
        mus = torch.as_tensor(np.stack([xcom.mixatten(b.matcomp, spec.E)
                                        for b in basis]),
                              dtype=torch.float32, device=dev)
        dec_i0 = torch.as_tensor(i0s, dtype=torch.float32, device=dev)
        cases.append((label, counts, dec_i0, mus, n_iters, basis is basis4))
        del paths, c, want
    for label, counts, dec_i0, mus, n_iters, recorded in cases:
        kw = dict(n_iters=n_iters)
        ab, want, ms, pms = compare_once(
            lambda: matdecomp.gauss_newton_solve(counts, dec_i0, mus, **kw),
            lambda: matdecomp.gauss_newton_solve_plain(counts, dec_i0, mus,
                                                       **kw), reps=2)
        worst, p99 = tiny_cases.newton_agreement(ab, want)
        err = float((ab - want).abs().max())
        M, K = counts.shape[0], mus.shape[0]
        report(records, "gauss_newton_general", err, ms, pms,
               tiny_cases.newton_agrees(ab, want) and
               bool(torch.isfinite(ab).all()),
               newton_work(counts.shape[1], M, K, n_iters, mus.shape[1]),
               extra=f" ({label}, {n_iters} iterations, {counts.shape[1]} "
                     f"pixels, {mus.shape[1]} energies; rel max {worst:.3g},"
                     f" 99th percentile {p99:.3g})", record=recorded)
    del cases
    # (2, 2) beside K3 on the exact path's DE counts, K3's schedule
    ct2, ph2 = cfg.ct, cfg.phantom
    s1, s2 = spectra(ct2)
    paths = siddon.material_path_sinogram(ph2, ct2, device=dev)
    flat = torch.stack([spectral.forward_counts(paths, ph2, s, ct2)[0]
                        .reshape(-1) for s in (s1, s2)])
    del paths
    _, i0, mus = matdecomp.prepare_decomposition(ct2, s1, s2)
    i0, mus = (torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in (i0, mus))
    kw = dict(n_iters=50, eps_init=1e-6, pixel_block=65536, step_max=5.0,
              a_bounds=(-20.0, 500.0), method="gn", lm_damping=0.0,
              polish_iters=4, warm="log", warm_nodes=32)
    k35 = matdecomp._gauss_newton_general(flat, i0, mus, **kw)
    k3 = matdecomp.gauss_newton_solve(flat, i0, mus, n_iters=50)
    rel = float(((k35 - k3).abs() / k3.abs().clamp_min(1.0)).max())
    t35 = time_ms(lambda: matdecomp._gauss_newton_general(flat, i0, mus,
                                                          **kw), 2)
    t3 = time_ms(lambda: matdecomp.gauss_newton_solve(flat, i0, mus,
                                                      n_iters=50), 2)
    print(f"  gauss_newton_general at (2, 2) (the exact path's DE counts, "
          f"{flat.shape[1]} pixels, 50 iterations): kernel={t35:.4f} ms, "
          f"K3 {t3:.4f} ms, max |d| / max(|a|, 1) from K3 {rel:.3g} "
          f"[<= 1e-4]")
    if not rel <= 1e-4:
        fail("gauss_newton_general disagrees with K3 at (2, 2)")


def rod_check(scene, reading):
    """Print each rod's reading of the K-edge ``scene`` beside the JAX
    package's half-resolution one; True when each rod reads its agent at
    KEDGE_AGENT and not the other, and the JAX reading, within
    KEDGE_TOL."""
    ok = True
    for rod, (i_, g_) in reading.items():
        want = (KEDGE_AGENT, 0.0) if rod == "iodine" else (0.0, KEDGE_AGENT)
        ref = KEDGE_REF[scene][rod]
        print(f"  K-edge {scene} {rod} rod: iodine {i_:.5f}, gadolinium "
              f"{g_:.5f} g/cm^3 (JAX at half resolution {ref[0]:.5f}, "
              f"{ref[1]:.5f})")
        ok &= all(abs(x - w) <= KEDGE_TOL for x, w in zip((i_, g_), want))
        ok &= all(abs(x - r) <= KEDGE_TOL for x, r in zip((i_, g_), ref))
    return ok


def spectral_path(cfg, pcd, records, smi, dev):
    """Phase 4, spectral photon-counting CT at the reference protocol, each
    run twice with its stages timed: (a) ``pack_pcd_spectral`` +
    ``pcd_step`` (bins PCD_THRESHOLDS, basis tissue/bone, 10 iterations,
    ``siddon_dominant``/``parallel``, pileup at PCD_PILEUP_RHO), with
    Poisson noise from the run's seed (finite, the basis sinograms within
    a_bounds: the pelvis's lateral rays starve the lowest bins, and their
    Poisson counts rail some rays at the bound, as the JAX package's noise
    test anticipates, tests/test_spectralct.py:220-238) and without noise
    (the tissue ROI within TISSUE_TOL of 1.06 g/cm^3); (b) the K-edge
    scenes through ``simulate_pcd_spectral`` (6 bins, water/bone/iodine/
    gadolinium, 60 iterations): finite; on the
    cylinder each rod reads its agent at 0.010 and not the other, and the
    JAX package's half-resolution reading, within KEDGE_TOL (rod_check),
    and the water between the rods reads its 70 keV VMI within 2 % of
    water's mu; the pelvis's readings printed beside JAX's.  Launch
    counters as every path's."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.physics import xcom
    from dexct_tpu_torch.physics.materials import BONE, TISSUE, WATER
    from dexct_tpu_torch.pipeline import spectralct

    pcfg, spec, kph, basis4 = pcd
    ct, img = pcfg.ct, (pcfg.N_matrix, pcfg.FOV, pcfg.ramp)
    images = {"pelvis": (pcfg.N_matrix, pcfg.FOV),
              "cylinder": KEDGE_CYLINDER_IMAGE}
    mu_w = float(xcom.mixatten(WATER.matcomp, np.array([70.0]))[0])
    air = float(matdecomp.pcd_bin_fluences(ct, spec, PCD_THRESHOLDS).sum())
    pk = dict(n_iters=10, pileup_tau=PCD_PILEUP_RHO / air, device=dev)
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        a, m = spectralct.pack_pcd_spectral(
            ct, pcfg.phantom, spec, list(PCD_THRESHOLDS), (TISSUE, BONE),
            *img, noise="poisson", seed=run, **pk)
        st.mark("pack_pcd_spectral")
        noisy = spectralct.pcd_step(a, m)
        st.mark("pcd_step, Poisson noise")
        a0, m0 = spectralct.pack_pcd_spectral(
            ct, pcfg.phantom, spec, list(PCD_THRESHOLDS), (TISSUE, BONE),
            *img, **pk)
        st.mark("pack_pcd_spectral")
        out = spectralct.pcd_step(a0, m0)
        st.mark("pcd_step, no noise")
        kedge = {}
        for scene, (n, fov) in images.items():
            kedge[scene] = spectralct.simulate_pcd_spectral(
                ct, kph[scene], spec, list(KEDGE_THRESHOLDS), basis4, n, fov,
                pcfg.ramp, n_iters=60, device=dev)
            st.mark(f"simulate_pcd_spectral, K-edge {scene}")
        print(f"spectral path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("spectral", fns, SPECTRAL_KERNELS, records)
    print_profiled("spectral pcd_step (Poisson noise)",
                   lambda: spectralct.pcd_step(a, m))
    recons = out["basis_recons"].cpu().numpy()
    tis = roi_mean(recons[0][None], *TISSUE_XY, 0, pcfg.FOV)
    bone = roi_mean(recons[1][None], *TISSUE_XY, 0, pcfg.FOV)
    vmi = roi_mean(kedge["cylinder"].vmi(70.0).cpu().numpy()[None], 0.0,
                   0.0, 0, KEDGE_CYLINDER_IMAGE[1])
    finite = all(bool(torch.isfinite(x).all()) for x in (
        out["basis_sinos"], out["basis_recons"], noisy["basis_sinos"],
        noisy["basis_recons"], *(r.basis_sinos for r in kedge.values()),
        *(r.basis_recons for r in kedge.values())))
    rail = float(noisy["basis_sinos"].max())
    railed = float((noisy["basis_sinos"] >= m.a_hi).float().mean())
    print(f"  packed PCD (pileup): tissue ROI {tis:.4f} g/cm^3 (ICRU tissue "
          f"{TISSUE_DENSITY}), bone {bone:.4f}; with Poisson noise the "
          f"basis sinograms reach {rail:.4g} g/cm^2 ({railed:.4g} of them at "
          f"a_hi {m.a_hi:g}); K-edge "
          f"cylinder: water VMI(70 keV) {vmi:.5f} 1/cm, water {mu_w:.5f} "
          f"(off {vmi / mu_w - 1.0:.4f}); finite: {finite}")
    rods = rod_check("cylinder", kedge_reading(
        kedge["cylinder"].basis_recons, KEDGE_CYLINDER_IMAGE[1], "cylinder"))
    rod_check("pelvis", kedge_reading(kedge["pelvis"].basis_recons,
                                      pcfg.FOV, "pelvis"))
    if not (finite and abs(tis - TISSUE_DENSITY) <= TISSUE_TOL
            and rail <= m.a_hi and abs(vmi / mu_w - 1.0) <= 0.02 and rods):
        fail("the spectral path misses its checks")


def spectral_cone_path(tmp, cone_cfgs, records, smi, dev, gens):
    """Phase 4, cone-beam photon counting: the cone config (360 x 16 x 256)
    as a PCD scan through ``pack_pcd_spectral_cone`` + ``pcd_cone_step``
    and ``simulate_pcd_spectral_cone`` (4 bins, tissue/bone, 10
    iterations; K10, K34, K35, K11), and the helical config's packed step
    (K12; the JAX ``simulate_pcd_spectral_cone`` reconstructs circular
    orbits only).  Each finite, the central slice's tissue ROI within
    TISSUE_TOL of 1.06 g/cm^3, the packed and stateless cone volumes
    within 1e-3 of each other."""
    import torch

    from dexct_tpu_torch.physics.materials import BONE, TISSUE
    from dexct_tpu_torch.pipeline import spectralct
    from dexct_tpu_torch.pipeline.runner import _resolve_spectrum
    from dexct_tpu_torch.system.config import read_parameter_file

    basis, thr = (TISSUE, BONE), list(PCD_THRESHOLDS)
    fns = zero_counters()
    vols = {}
    for label in ("cone", "helical"):
        ccfg = read_parameter_file(write_cone_params(
            tmp, f"pcd_{label}", {**CONE_CONFIGS[label], **PCD_PARAMS}))[0]
        ct = ccfg.ct
        spec = _resolve_spectrum("140kV", PCD_DOSE_MGY, ct, str(SPECTRA),
                                 gens)
        img = (ccfg.N_matrix, ccfg.FOV, ccfg.ramp)
        st = Stages()
        a, m = spectralct.pack_pcd_spectral_cone(
            ct, ccfg.phantom, spec, thr, basis, *img, n_iters=10,
            device=dev)
        st.mark("pack_pcd_spectral_cone")
        out = spectralct.pcd_cone_step(a, m)
        st.mark("pcd_cone_step")
        vols[label] = (out["basis_recons"], ccfg.FOV)
        if label == "cone":
            res = spectralct.simulate_pcd_spectral_cone(
                ct, ccfg.phantom, spec, thr, basis, *img, n_iters=10,
                device=dev)
            st.mark("simulate_pcd_spectral_cone")
            vols["stateless"] = (res.basis_recons, ccfg.FOV)
        del a, out
        print(f"spectral_cone path ({label}, library): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
        torch.cuda.empty_cache()
    check_launches("spectral_cone", fns, SPECTRAL_CONE_KERNELS, records)
    ok = True
    for label, (v, fov) in vols.items():
        mid = v.shape[1] // 2
        tis = roi_mean(v[0].cpu().numpy(), *TISSUE_XY, mid, fov)
        fin = bool(torch.isfinite(v).all())
        print(f"  {label}: {tuple(v.shape)} basis volumes, central slice "
              f"tissue ROI {tis:.4f} g/cm^3; finite: {fin}")
        ok &= fin and abs(tis - TISSUE_DENSITY) <= TISSUE_TOL
    d = float((vols["cone"][0] - vols["stateless"][0]).abs().max())
    print(f"  packed vs stateless cone volumes: max abs {d:.3g} [<= 1e-3]")
    if not (ok and d <= 1e-3):
        fail("the spectral_cone path misses its checks")


def acquisition_modes_path(cfg, spectra, records, smi, dev, gens):
    """Phase 4, the other DE acquisition geometries at the reference
    protocol, each once with its wall time: ``simulate_kvswitch_dect``,
    ``simulate_dualsource_dect`` (cross_spr 0.1, corrected) and
    ``simulate_dual_layer_dect`` (140 kV at 10 mGy through the sandwich
    detector).  Each: the 80 kV (or back-layer) air ROI at (0, -20) cm
    within 50 HU of -1000, the tissue ROI's tissue density within
    TISSUE_TOL of 1.06 g/cm^3."""
    import torch

    from dexct_tpu_torch.physics.duallayer import simulate_dual_layer_dect
    from dexct_tpu_torch.pipeline.dualsource import simulate_dualsource_dect
    from dexct_tpu_torch.pipeline.kvswitch import simulate_kvswitch_dect
    from dexct_tpu_torch.pipeline.runner import _resolve_spectrum

    ct, ph = cfg.ct, cfg.phantom
    s1, s2 = spectra(ct)
    img = (cfg.N_matrix, cfg.FOV, cfg.ramp)
    s140 = _resolve_spectrum("140kV", PCD_DOSE_MGY, ct, str(SPECTRA), gens)
    runs = {
        "kvswitch": lambda: simulate_kvswitch_dect(ct, ph, s1, s2, *img,
                                                   n_iters=50, device=dev),
        "dualsource": lambda: simulate_dualsource_dect(
            ct, ph, s1, s2, *img, cross_spr=0.1, correct=True, n_iters=50,
            device=dev),
        "duallayer": lambda: simulate_dual_layer_dect(ct, ph, s140, *img,
                                                      n_iters=50,
                                                      device=dev),
    }
    fns = zero_counters()
    ok = True
    for label, run in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        air = roi_mean(out.recon_HU[1][None].cpu().numpy(), 0.0, -20.0, 0,
                       cfg.FOV)
        tis = roi_mean(out.mat_recons[0][None].cpu().numpy(), *TISSUE_XY, 0,
                       cfg.FOV)
        fin = all(bool(torch.isfinite(x).all()) for pair in (
            out.sino_log, out.mat_sinos, out.recon_HU, out.mat_recons)
            for x in pair)
        print(f"acquisition_modes {label} (library): {wall:.3f} s on {smi}; "
              f"air ROI {air:.2f} HU, tissue ROI {tis:.4f} g/cm^3; finite: "
              f"{fin}")
        ok &= fin and abs(air + 1000.0) <= 50.0 \
            and abs(tis - TISSUE_DENSITY) <= TISSUE_TOL
    check_launches("acquisition_modes", fns, ACQUISITION_KERNELS, records)
    if not ok:
        fail("an acquisition-mode path misses its checks")


def gather_probe_path(records, smi):
    """Phase 4, the gather-rate probe through its entry point
    (``python -m dexct_tpu_torch.tools.bench_gather``'s ``main``): every
    probe at 2^24 lookups; K38 and K39 must launch, and no other kernel."""
    from dexct_tpu_torch.tools import bench_gather

    fns = zero_counters()
    print(f"gather_probe path (bench_gather.main, 2^24 lookups, {smi}):")
    probes = bench_gather.main(["--n-log2", "24", "--reps", "20"])
    check_launches("gather_probe", fns, GATHER_KERNELS, records)
    if len(probes) < 10 or not all(p["ms"] > 0 for p in probes):
        fail("the gather probe did not time every probe")


def dose_study_readings(mats, sig, bg):
    """The JAX dose study's readings (tools/dose_study_full.py:103-136) of
    two realizations' basis images [D, 2, N, N] through the port's
    analysis: the VMI(70) contrast at the nominal dose, the 70 keV noise at
    each dose (the std of the difference of the realizations over sqrt 2
    in the background ROI) and its exponent against dose."""
    import numpy as np

    from dexct_tpu_torch import analysis

    scales = np.asarray(DOSE_STUDY_SCALES)
    i_nom = DOSE_STUDY_SCALES.index(1.0)
    vmi = [[np.asarray(analysis.make_vmi(70.0, m[i, 0], m[i, 1]))
            for i in range(len(scales))] for m in mats]
    contrast = float(analysis.contrast(vmi[0][i_nom], sig, bg))
    noises = [float(np.std(bg.extract((vmi[0][i] - vmi[1][i])
                                      / np.sqrt(2.0))))
              for i in range(len(scales))]
    cnr = float(analysis.cnr(vmi[0][i_nom], sig, bg))
    p = float(np.polyfit(np.log(scales), np.log(noises), 1)[0])
    return contrast, cnr, noises, p


def sweep_path(records, smi, dev):
    """Phase 4, the parameter sweeps through the library, twice.  The JAX
    package's dose study (``tools/dose_study_full.py``): ``dose_sweep``
    over five doses with compound noise, seeds 17 and 18, read through the
    port's ``analysis``: the noise-dose exponent within DOSE_EXPONENT_TOL
    and the VMI(70) contrast within VMI70_CONTRAST_TOL_HU of the committed
    JAX readings (kernels K1, K2, K3, K5, K6 only).  BASELINE config 5's
    width: ``dose_sweep`` with no noise at 0.5 and 2.0 (HU images within
    0.3 HU), ``ramp_sweep`` over sinc ramps 0.3, 0.8, 1.0 (edge sharpness
    rising, >= 1.3x from 0.3 to 1.0), ``slice_sweep`` over the pelvis, an
    empty slice and the pelvis rolled by 5 and 21 columns (slice 0 within
    1e-5 HU of one ``dect_step``, the empty slice below -900 HU) (kernels
    K1-K4 only).  Then the stages once more: host pack, the shared trace
    and counts, the points, the copies to the host, and the device's busy
    share over one more sweep."""
    import numpy as np
    import torch

    from dexct_tpu_torch import analysis
    from dexct_tpu_torch.ops.filters import filter_frequency_response
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.pipeline import sweep
    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.system import FanBeamGeometry, pelvis_phantom

    ref = json.loads((ROOT / "results" / "dose_study_full.json")
                     .read_text())["cases"]["pelvis/MV-80kV"]
    exp_ref = ref["vs_dose"]["noise_dose_exponent"]
    c70_ref = ref["vmi"]["70"]["contrast_hu"]

    def scan(n_ch, n_proj):
        ct = FanBeamGeometry(N_channels=n_ch, N_proj=n_proj,
                             gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                             eid=True)
        s1 = linac_spectrum()
        s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
        s2 = kramers_spectrum(80.0)
        s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
        return ct, s1, s2

    ct, s1, s2 = scan(800, 1000)
    ph = pelvis_phantom(N=512, dx=50.0 / 512)
    hct, hs1, hs2 = scan(1600, 1440)
    hph = pelvis_phantom(N=1024, dx=0.05)
    sig, bg = (analysis.Roi(*r) for r in DOSE_STUDY_ROIS)
    study = dict(n_iters=12, recon="parallel", recon_n_theta=512,
                 recon_nt=1600, noise="compound", seed=17)
    Hs = np.stack([filter_frequency_response(hct.N_channels, hct.dgamma, r,
                                             "sinc", "fan")[0]
                   for r in HIGHRES_RAMPS])

    def edge(img):
        return float((img[img.shape[0] // 2, 1:]
                      - img[img.shape[0] // 2, :-1]).abs().max())

    for run in (1, 2):
        fns = zero_counters()
        st = Stages()
        arrays, meta = pack_dect(ct, ph, s1, s2, 512, 50.0, 0.8, device=dev,
                                 **study)
        st.mark("pack")
        outs = [sweep.dose_sweep(arrays, meta, DOSE_STUDY_SCALES, seed,
                                 noise="compound")
                for seed in DOSE_STUDY_SEEDS]
        st.mark("two dose sweeps")
        mats = [o["mat_recons"].cpu().numpy() for o in outs]
        st.mark("copies to the host")
        c70, cnr, noises, p = dose_study_readings(mats, sig, bg)
        st.mark("analysis")
        print(f"sweep path, dose study (run {run}, {smi}): stages (ms) "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
        print(f"  VMI(70) contrast {c70:.3f} HU (JAX {c70_ref:.3f}), CNR "
              f"{cnr:.4f}; 70 keV noise vs dose {DOSE_STUDY_SCALES}: "
              + ", ".join(f"{n:.3f}" for n in noises)
              + f" HU; exponent {p:.4f} (JAX {exp_ref:.4f})")
        check_launches("sweep (dose study)", fns, SWEEP_PARALLEL_KERNELS,
                       records)
        if not (abs(p - exp_ref) <= DOSE_EXPONENT_TOL
                and abs(c70 - c70_ref) <= VMI70_CONTRAST_TOL_HU):
            fail("the dose study misses the JAX package's readings")
        if not all(bool(torch.isfinite(o[k]).all()) for o in outs
                   for k in o):
            fail("the dose study gives non-finite values")
        del outs, arrays
        torch.cuda.empty_cache()

        fns = zero_counters()
        st = Stages()
        harr, hmeta = pack_dect(hct, hph, hs1, hs2, 1024, 50.0, 0.8,
                                device=dev, n_iters=10, projector="siddon",
                                recon="fan")
        st.mark("pack")
        dose = sweep.dose_sweep(harr, hmeta, [0.5, 2.0], 0, noise="none")
        st.mark("dose_sweep (2 doses)")
        ramp = sweep.ramp_sweep(harr, hmeta, Hs)
        st.mark("ramp_sweep (3 ramps)")
        base = harr["labels"].cpu().numpy()
        vol = np.stack([base, np.zeros_like(base), np.roll(base, 5, 1),
                        np.roll(base, 21, 1)])
        sl = sweep.slice_sweep(harr, hmeta, vol)
        st.mark("slice_sweep (4 slices)")
        single = dect_step(harr, hmeta)
        st.mark("one dect_step")
        check_launches("sweep (config 5)", fns, SWEEP_FAN_KERNELS, records)
        d_hu = float((dose["recon_HU"][0] - dose["recon_HU"][1]).abs().max())
        edges = [edge(ramp[k, 1]) for k in range(len(HIGHRES_RAMPS))]
        d_slice = max(float((sl["recon_HU"][i][0] - single["recon_HU"][i])
                            .abs().max()) for i in range(2))
        empty = [float(sl["recon_HU"][i][1].mean()) for i in range(2)]
        print(f"sweep path, config 5 (run {run}, {smi}): stages (ms) "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
        print(f"  noiseless doses 0.5 vs 2.0: max |HU difference| "
              f"{d_hu:.4f}; ramp {HIGHRES_RAMPS} 80 kV edge "
              + ", ".join(f"{e:.2f}" for e in edges)
              + f" HU ({edges[-1] / edges[0]:.3f}x); slice 0 vs dect_step "
              f"{d_slice:.3g} HU; empty slice mean {empty[0]:.1f}, "
              f"{empty[1]:.1f} HU")
        if not (d_hu <= 0.3 and edges[0] < edges[1] < edges[2]
                and edges[2] >= 1.3 * edges[0] and d_slice <= 1e-5
                and max(empty) < -900.0):
            fail("the config 5 sweeps miss their checks")
        del dose, ramp, sl, single
        torch.cuda.empty_cache()

    # the stages once more, and the device's busy share
    st = Stages()
    arrays, meta = pack_dect(ct, ph, s1, s2, 512, 50.0, 0.8, device=dev,
                             **study)
    st.mark("pack")
    sweep._base_counts(arrays, meta, True)
    st.mark("shared trace and four counts")
    out = sweep.dose_sweep(arrays, meta, DOSE_STUDY_SCALES, 17,
                           noise="compound")
    st.mark("dose_sweep")
    host = {k: v.cpu() for k, v in out.items()}
    st.mark("copies to the host")
    per_point = (st.t["dose_sweep"] - st.t["shared trace and four counts"]) \
        / len(DOSE_STUDY_SCALES)
    print(f"  sweep dose study stages (ms, {smi}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in st.t.items())
          + f"; per point {per_point:.2f}")
    print_profiled("sweep dose study (dose_sweep)", lambda: sweep.dose_sweep(
        arrays, meta, DOSE_STUDY_SCALES, 17, noise="compound"))
    del out, host, arrays
    torch.cuda.empty_cache()
    harr, hmeta = pack_dect(hct, hph, hs1, hs2, 1024, 50.0, 0.8, device=dev,
                            n_iters=10, projector="siddon", recon="fan")
    print_profiled("sweep config 5 (slice_sweep, 4 slices)",
                   lambda: sweep.slice_sweep(harr, hmeta, vol))
    print_profiled("sweep config 5 (dose_sweep, 2 doses)",
                   lambda: sweep.dose_sweep(harr, hmeta, [0.5, 2.0], 0,
                                            noise="none"))
    del harr
    torch.cuda.empty_cache()


def sweep_devices_phase():
    """Phase 5: the tiny sweeps of ``dexct_tpu_torch.utils.tiny_cases``
    (tests/test_sweep.py's 64^2 cylinder: dose on the fan and the parallel
    grid, ramp, slice) on the CPU and on the card, each output within its
    SWEEP_TOL (the card tests run the same cases)."""
    from dexct_tpu_torch.utils import tiny_cases as tc

    for kind in tc.SWEEP_KINDS:
        c, g = tc.sweep(kind, "cpu"), tc.sweep(kind, "cuda")
        errs = {k: float((g[k] - c[k]).abs().max()) for k in c}
        print(f"  sweep {kind}: card vs CPU max abs "
              + ", ".join(f"{k} {e:.3g} [<= {tc.SWEEP_TOL[k]:g}]"
                          for k, e in errs.items()))
        if not all(e <= tc.SWEEP_TOL[k] for k, e in errs.items()):
            fail(f"tiny sweep {kind} differs between the CPU and the card")


def spectral_devices_phase():
    """Phase 5: the tiny spectral paths of ``dexct_tpu_torch.utils.
    tiny_cases`` (photon-counting CT in 2-D and as a cone, kV switching,
    dual source with cross-scatter and motion, dual layer) on the CPU and
    on the card, each output within SPECTRAL_TOL of its maximum (the card
    tests run the same cases)."""
    from dexct_tpu_torch.utils import tiny_cases as tc

    for kind in tc.SPECTRAL_KINDS:
        c, g = tc.spectral(kind, "cpu"), tc.spectral(kind, "cuda")
        errs = [float((gi - ci).abs().max() / ci.abs().max())
                for gi, ci in zip(g, c)]
        print(f"  spectral {kind}: card vs CPU max abs / max per output "
              + ", ".join(f"{e:.3g}" for e in errs)
              + f" [<= {tc.SPECTRAL_TOL:g}]")
        if not max(errs) <= tc.SPECTRAL_TOL:
            fail(f"tiny spectral path {kind} differs between the CPU and "
                 "the card")


def counters():
    from dexct_tpu_torch.ops import (afterglow, conebeam, dose, fbp_fast,
                                     flatpanel, fourier, helical_pi,
                                     katsevich, matdecomp, motion, noisemap,
                                     scatter_physics, siddon, spectral)
    from dexct_tpu_torch.pipeline import gated
    from dexct_tpu_torch.system import analytic
    from dexct_tpu_torch.tools import bench_gather

    return {"siddon_trace": siddon.trace_paths,
            "spectral_counts": spectral.counts_from_paths,
            "gauss_newton": matdecomp.gauss_newton_solve,
            "fan_backproject": fbp_fast.fan_backproject_multi,
            "rebin_to_parallel": fbp_fast.rebin_to_parallel,
            "parallel_backproject": fbp_fast.parallel_backproject_multi,
            "kb_sample": fourier.kb_sample,
            "resample_to_fan": fourier.resample_to_fan,
            "analytic_chords": analytic.analytic_paths,
            "siddon_trace_3d": conebeam.trace_paths_3d,
            "fdk_backproject": conebeam._fdk_backproject_multi,
            "helical_backproject": conebeam._helical_backproject,
            "flat_backproject": flatpanel._flat_backproject,
            "katsevich_derivative": katsevich._fixed_direction_derivative,
            "katsevich_backproject": katsevich._katsevich_backproject,
            "trilinear_sample": conebeam._trilinear_volume_sample,
            "siddon_trace_stack": siddon.trace_paths_stack,
            "project_3d": conebeam.project_volume_3d,
            "backproject_3d": conebeam.project_volume_3d_adjoint,
            "cone_transpose": conebeam.cone_transpose,
            "pi_backproject": helical_pi._pi_backproject,
            "kb_sample_adjoint": fourier.kb_sample_adjoint,
            "resample_to_fan_adjoint": fourier.resample_to_fan_adjoint,
            "dose_map": dose._dose_accumulate,
            "dose_map_3d": dose._dose_accumulate_3d,
            "fan_backproject_var": noisemap._fan_backproject_var,
            "single_scatter": scatter_physics._scatter_scan,
            "single_scatter_conebeam": scatter_physics._scatter_scan_cone,
            "table_counts": spectral.counts_from_table,
            "gauss_newton_grouped": matdecomp.gauss_newton_solve_grouped,
            "fan_backproject_motion": motion.fan_backproject_motion,
            "gated_backproject": gated._gated_backproject,
            "fdk_backproject_motion": motion._fdk_backproject_motion,
            "helical_backproject_motion":
                motion._helical_backproject_motion,
            "multibin_counts": spectral.counts_from_paths_multibin,
            "gauss_newton_general": matdecomp._gauss_newton_general,
            "afterglow_apply": afterglow.apply_afterglow,
            "afterglow_correct": afterglow.correct_afterglow,
            "gather_vmem": bench_gather.gather_vmem,
            "gather_take": bench_gather.gather_take}


def zero_counters():
    """The launch counters, each set to 0."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    return fns


def check_launches(label, fns, path_kernels, records):
    """Fail unless exactly the path's kernels launched since the counts
    were set to 0; add the counts to the records."""
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"  launches: {launches}")
    for name, n in launches.items():
        if name in path_kernels and n <= 0:
            fail(f"kernel {name} was not launched on the {label} path")
        if name not in path_kernels and n != 0:
            fail(f"kernel {name} was launched on the {label} path")
        records[name]["launches"] += n


def write_cone_params(tmp, label, spec):
    """A params file of one of the repo's cone configurations, with its
    pelvis_phantom_3d (N 256, 0.2 cm voxels) written beside it."""
    from dexct_tpu_torch.system.phantom import pelvis_phantom_3d

    spec = dict(spec)
    nz = spec.pop("phantom_nz")
    ph = pelvis_phantom_3d(N=256, nz=nz, dx=0.2, dz=0.2)
    ph.to_file(str(tmp / f"{label}.bin"), str(tmp / f"{label}.csv"))
    cfg = json.loads(PARAMS.read_text())
    cfg.update({"RUN_ID": label, "phantom_id": ph.name,
                "phantom_filename": str(tmp / f"{label}.bin"),
                "matcomp_filename": str(tmp / f"{label}.csv"),
                "Nx": 256, "Ny": 256, "Nz": nz, "dx": 0.2, "dy": 0.2,
                "dz": 0.2, "N_rows": 16, "detector_px_height": 0.25,
                "N_channels": 256, "SID": 60.0, "SDD": 100.0,
                "fan_angle_total": 0.8230337,
                "detector_filename": str(ROOT / cfg["detector_filename"]),
                "N_recon_matrix": 256, "FOV_recon": 40.0, **spec})
    path = tmp / f"{label}.txt"
    path.write_text(json.dumps(cfg))
    return path


def check_outputs(out_dir, run_id, n_views, n_ch, n_img,
                  air_xy=(0.0, -20.0)):
    """Phase 4 checks on the §2.6 files of the reference protocol, with an
    air ROI at ``air_xy`` cm."""
    import numpy as np

    acq = [out_dir / run_id / "detunedMV_9000uGy",
           out_dir / run_id / "80kV_1000uGy"]
    md = out_dir / run_id / "matdecomp_detunedMV_80kV_9000uGy_1000uGy"
    want = {}
    for d in acq:
        for f in ("sino_raw", "sino_log"):
            want[d / f"{f}_float32.bin"] = n_views * n_ch * 4
        for f in ("recon_raw", "recon_HU"):
            want[d / f"{f}_float32.bin"] = n_img * n_img * 4
    for i in (1, 2):
        want[md / f"mat{i}_sino_float32.bin"] = n_views * n_ch * 4
        want[md / f"mat{i}_recon_float32.bin"] = n_img * n_img * 4
    for path, size in want.items():
        if not path.exists():
            fail(f"missing output {path}")
        if path.stat().st_size != size:
            fail(f"{path} has {path.stat().st_size} bytes, want {size}")
        if not np.all(np.isfinite(np.fromfile(path, np.float32))):
            fail(f"{path} holds non-finite values")
    # air ROI inside the FOV: 1 cm x 1 cm at (x, y) = (0, -20) cm, 5 cm
    # below the pelvis body (which spans |y| <= 14.7 cm)
    hus = []
    for d in acq:
        hu = np.fromfile(d / "recon_HU_float32.bin", np.float32).reshape(
            1, n_img, n_img)
        hus.append(roi_mean(hu, *air_xy, 0, 50.0))
    print(f"  air ROI HU at {air_xy} cm: detunedMV {hus[0]:.2f}, 80kV "
          f"{hus[1]:.2f}")
    if not all(abs(h_ + 1000.0) <= 50.0 for h_ in hus):
        fail(f"air ROI is not ~-1000 HU: {hus}")
    return len(want)


def roi_box(vol, x, y, iz, fov=40.0, half_cm=0.5):
    """The square ROI of half-width ``half_cm`` centred at (x, y) cm in
    slice ``iz`` of a [nz, N, N] volume over ``fov`` cm."""
    n_img = vol.shape[-1]
    px = fov / n_img
    iy = int(round(y / px + n_img / 2 - 0.5))
    ix = int(round(x / px + n_img / 2 - 0.5))
    h = max(int(round(half_cm / px)), 1)
    return vol[iz, iy - h:iy + h, ix - h:ix + h]


def roi_mean(vol, x, y, iz, fov=40.0):
    """Mean of the 1 cm x 1 cm ROI centred at (x, y) cm in slice ``iz`` of
    a [nz, N, N] volume over ``fov`` cm."""
    return float(roi_box(vol, x, y, iz, fov).mean())


def check_outputs_3d(out_dir, run_id, vrc, nz, n_img, tilted=False):
    """Phase 4 checks on a 3-D path's files: [V, R, C] sinograms and
    [nz, N, N] volumes, finite, air ~ -1000 HU inside the scanned cone.
    Returns the file count and both acquisitions' HU in a 1 cm² ROI at the
    centre of the central slice (the pelvis's bladder, water)."""
    import numpy as np

    V, R, C = vrc
    acq = [out_dir / run_id / "detunedMV_9000uGy",
           out_dir / run_id / "80kV_1000uGy"]
    md = out_dir / run_id / "matdecomp_detunedMV_80kV_9000uGy_1000uGy"
    want = {}
    for d in acq:
        for f in ("sino_raw", "sino_log"):
            want[d / f"{f}_float32.bin"] = V * R * C * 4
        for f in ("recon_raw", "recon_HU"):
            want[d / f"{f}_float32.bin"] = nz * n_img * n_img * 4
    for i in (1, 2):
        want[md / f"mat{i}_sino_float32.bin"] = V * R * C * 4
        want[md / f"mat{i}_recon_float32.bin"] = nz * n_img * n_img * 4
    for path, size in want.items():
        if not path.exists():
            fail(f"missing output {path}")
        if path.stat().st_size != size:
            fail(f"{path} has {path.stat().st_size} bytes, want {size}")
        if not np.all(np.isfinite(np.fromfile(path, np.float32))):
            fail(f"{path} holds non-finite values")
    # air ROI inside the 40 cm FOV and the scanned cone. Untilted: at
    # (x, y) = (0, -18) cm of the central slice, below the pelvis body
    # (|y| <= 14.9 cm). Tilted 15 degrees, that point's gantry image lies
    # 4.7 cm off the midplane, outside the +-2 cm the rows cover, so the
    # ROI moves to (16, -10.5) cm of the first slice (z = -1.875 cm), air
    # beside the tapered caudal body, whose gantry image lies 0.9 cm off
    # the midplane; its raw values must then be nonzero.
    x, y, iz = (16.0, -10.5, 0) if tilted else (0.0, -18.0, nz // 2)
    hus, body, raw = [], [], []
    for d in acq:
        hu = np.fromfile(d / "recon_HU_float32.bin", np.float32).reshape(
            nz, n_img, n_img)
        hus.append(roi_mean(hu, x, y, iz))
        body.append(roi_mean(hu, 0.0, 0.0, nz // 2))
        mu = np.fromfile(d / "recon_raw_float32.bin", np.float32).reshape(
            nz, n_img, n_img)
        raw.append(roi_mean(np.abs(mu), x, y, iz))
    print(f"  air ROI HU at ({x:g}, {y:g}) cm, slice {iz}: detunedMV "
          f"{hus[0]:.2f}, 80kV {hus[1]:.2f} (mean |raw| {raw[0]:.4g}, "
          f"{raw[1]:.4g} cm^-1); body ROI HU at (0, 0), slice {nz // 2}: "
          f"{body[0]:.2f}, {body[1]:.2f}")
    if not all(abs(h_ + 1000.0) <= 50.0 for h_ in hus):
        fail(f"air ROI is not ~-1000 HU: {hus}")
    if tilted and min(raw) == 0.0:
        fail("the tilted air ROI was not reconstructed (all zero)")
    return len(want), body


def profiled_run(step, top=6):
    """Wall and device kernel time [ms] of one more call of ``step`` under
    torch.profiler, the peak device memory [GB] of that call, and its
    ``top`` kernels by device time as (name, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    per = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        per.append((e.key, float(us or 0.0) / 1e3))
    per.sort(key=lambda kv: -kv[1])
    return (wall, sum(ms for _, ms in per),
            torch.cuda.max_memory_allocated() / 1e9, per[:top])


def profiled_step(step):
    """Wall and device kernel time [ms] of one more call of ``step`` under
    torch.profiler, and the peak device memory [GB] of that call."""
    return profiled_run(step)[:3]


def print_profiled(label, step):
    """One more call of ``step`` profiled: wall, device time, busy share,
    peak memory and the kernels that took the most device time."""
    wall, dev_ms, peak, top = profiled_run(step)
    print(f"  {label} profiled run: wall {wall:.3f} ms, device kernel time "
          f"{dev_ms:.3f} ms (busy share {dev_ms / wall:.3f}); peak device "
          f"memory {peak:.3f} GB; top kernels (ms): "
          + ", ".join(f"{k[:40]} {ms:.3f}" for k, ms in top))


def print_stages(label, t, step, smi):
    wall, dev_ms, peak = profiled_step(step)
    print(f"  {label} stages (ms, one pair, {smi}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    print(f"  {label} profiled step: wall {wall:.3f} ms, device kernel time "
          f"{dev_ms:.3f} ms (busy share {dev_ms / wall:.3f}); peak device "
          f"memory {peak:.3f} GB")


class Stages:
    """Host-clock stage timer with a synchronise at each stage edge."""

    def __init__(self):
        self.t = {}
        self.t0 = time.perf_counter()

    def mark(self, name):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[name] = (now - self.t0) * 1e3
        self.t0 = time.perf_counter()


def cone_stage_profile(cfg, label, tmp, smi):
    """One more DE pair of a 3-D path, stage by stage, and the device's
    busy share over one more step."""
    import torch

    from dexct_tpu_torch.pipeline.cone import cone_dect_step, pack_cone_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.utils.io import StageWriter

    st = Stages()
    gens = default_generators()
    s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
    s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
    st.mark("spectra")
    cfg.ct.ray_geometry_3d()
    st.mark("ray_geometry_3d (alone)")
    arrays, meta = pack_cone_dect(cfg.ct, cfg.phantom, s1, s2, cfg.N_matrix,
                                  cfg.FOV, cfg.ramp,
                                  device=torch.device("cuda"), n_iters=50)
    st.mark("pack_cone_dect (with its ray_geometry_3d)")
    out = cone_dect_step(arrays, meta)
    st.mark("cone_dect_step")
    writer = StageWriter(str(tmp / f"{label}_profile"), cfg.run_id)
    for i, (sid_, dose) in enumerate((("detunedMV", 9.0), ("80kV", 1.0))):
        writer.acquisition(sid_, dose, sino_raw=out["sino_raw"][i],
                           sino_log=out["sino_log"][i],
                           recon_raw=out["recon_raw"][i],
                           recon_HU=out["recon_HU"][i])
    writer.matdecomp("detunedMV", "80kV", 9.0, 1.0,
                     mat_sinos=list(out["mat_sinos"]),
                     mat_recons=list(out["mat_recons"]))
    st.mark("write the 12 files")
    del out
    print_stages(label, st.t, lambda: cone_dect_step(arrays, meta), smi)


def stateless_stage_profile(cfg, label, recon, tmp, smi):
    """One more DE pair of a stateless 3-D path, stage by stage: spectra,
    the rays alone, trace to decomposition (``do_recon=False``, with its own
    rays), the 4-volume reconstruction, the writes; then the device's busy
    share over one more whole ``simulate_cone_dect``."""
    import torch

    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.ops.fbp import hu_image
    from dexct_tpu_torch.pipeline.api import effective_water_mu
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.utils.io import StageWriter

    dev = torch.device("cuda")
    st = Stages()
    gens = default_generators()
    s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
    s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
    st.mark("spectra")
    cfg.ct.ray_geometry_3d()
    st.mark("ray_geometry_3d (alone)")
    args = (cfg.ct, cfg.phantom, s1, s2, cfg.N_matrix, cfg.FOV, cfg.ramp)
    out = conebeam.simulate_cone_dect(*args, device=dev, n_iters=50,
                                      do_recon=False)
    st.mark("trace to decomposition (with its ray_geometry_3d)")
    stack = torch.stack([out["sino_log"][0], out["sino_log"][1],
                         out["mat_sinos"][0], out["mat_sinos"][1]])
    vols = conebeam.reconstruct_3d(stack, cfg.ct, cfg.N_matrix, cfg.FOV,
                                   cfg.ramp, recon=recon)
    st.mark("reconstruction of 4 volumes")
    writer = StageWriter(str(tmp / f"{label}_profile"), cfg.run_id)
    for i, (sid_, dose) in enumerate((("detunedMV", 9.0), ("80kV", 1.0))):
        hu = hu_image(vols[i], effective_water_mu((s1, s2)[i], cfg.ct))
        writer.acquisition(sid_, dose, sino_raw=out["sino_raw"][i],
                           sino_log=out["sino_log"][i], recon_raw=vols[i],
                           recon_HU=hu)
    writer.matdecomp("detunedMV", "80kV", 9.0, 1.0,
                     mat_sinos=list(out["mat_sinos"]),
                     mat_recons=[vols[2], vols[3]])
    st.mark("write the 12 files")
    del out, stack, vols
    print_stages(label, st.t, lambda: conebeam.simulate_cone_dect(
        *args, device=dev, n_iters=50, recon=recon), smi)


def analytic_path(records, smi):
    """Phase 4, analytic projector through the library: pack_dect +
    dect_step on the reference protocol with pelvis_analytic(), twice,
    with the launch counters and the outputs checked."""
    import torch

    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.system.analytic import pelvis_analytic
    from dexct_tpu_torch.system.config import read_parameter_file

    cfg = read_parameter_file(PARAMS)[0]
    fns = zero_counters()
    walls = []
    for _ in (1, 2):
        t0 = time.perf_counter()
        gens = default_generators()
        s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
        s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
        arrays, meta = pack_dect(cfg.ct, pelvis_analytic(), s1, s2,
                                 cfg.N_matrix, cfg.FOV, cfg.ramp,
                                 device=torch.device("cuda"), n_iters=50,
                                 projector="analytic", recon="parallel")
        out = dect_step(arrays, meta)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"analytic path (library, pack_dect + dect_step): "
          f"{walls[0]:.3f} s (first), {walls[1]:.3f} s (steady) on {smi}")
    check_launches("analytic", fns, ANALYTIC_KERNELS, records)

    from dexct_tpu_torch.ops.fbp_fast import parallel_rebin_plan

    st = Stages()
    s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
    s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
    st.mark("spectra")
    cfg.ct.ray_geometry()
    st.mark("ray_geometry (alone)")
    parallel_rebin_plan(cfg.ct, 512, 1024)
    st.mark("parallel_rebin_plan (alone)")
    p_arrays, p_meta = pack_dect(cfg.ct, pelvis_analytic(), s1, s2,
                                 cfg.N_matrix, cfg.FOV, cfg.ramp,
                                 device=torch.device("cuda"), n_iters=50,
                                 projector="analytic", recon="parallel")
    st.mark("pack_dect (with both)")
    dect_step(p_arrays, p_meta)
    st.mark("dect_step")
    print_stages("analytic", st.t, lambda: dect_step(p_arrays, p_meta), smi)
    V, C, N = cfg.ct.N_proj, cfg.ct.N_channels, cfg.N_matrix
    for key in out:
        for i, x in enumerate(out[key]):
            shape = (V, C) if "sino" in key else (N, N)
            if tuple(x.shape) != shape:
                fail(f"analytic {key}[{i}] has shape {tuple(x.shape)}")
            if not bool(torch.isfinite(x).all()):
                fail(f"analytic {key}[{i}] holds non-finite values")
    px = cfg.FOV / N
    iy = int(round(-20.0 / px + N / 2 - 0.5))
    h = max(int(round(0.5 / px)), 1)
    hus = [float(out["recon_HU"][i][iy - h:iy + h, N // 2 - h:N // 2 + h]
                 .mean()) for i in (0, 1)]
    print(f"  12 outputs: exact shapes, finite; air ROI HU: detunedMV "
          f"{hus[0]:.2f}, 80kV {hus[1]:.2f}")
    if not all(abs(h_ + 1000.0) <= 50.0 for h_ in hus):
        fail(f"analytic air ROI is not ~-1000 HU: {hus}")


def write_2d_params(tmp, label, changes):
    """``input/params.txt`` with ``changes``, as the run config ``label``."""
    cfg = json.loads(PARAMS.read_text())
    cfg.update({"RUN_ID": label, **changes})
    path = tmp / f"{label}.txt"
    path.write_text(json.dumps(cfg))
    return path


def check_extra_2d(out_dir, cfg):
    """Phase 4 checks on the --bhc --denoise files: the denoised images of
    both acquisitions and the water and bone BHC images of both spectra,
    exact sizes and finite; prints the bladder ROI (water, at the centre)
    of recon_HU, the water-BHC image and the denoised image."""
    import numpy as np

    n = cfg.N_matrix
    rows = []
    for spec, dose in (("detunedMV", "9000uGy"), ("80kV", "1000uGy")):
        acq = out_dir / cfg.run_id / f"{spec}_{dose}"
        bhc = out_dir / cfg.run_id / f"{cfg.phantom.name}_bhc_{spec}"
        paths = ([acq / f"{f}_float32.bin" for f in DENOISED_FILES]
                 + [bhc / f"{f}_float32.bin" for f in BHC_FILES])
        imgs = {}
        for path in paths:
            if not path.exists():
                fail(f"missing output {path}")
            img = np.fromfile(path, np.float32)
            if img.size != n * n or not np.all(np.isfinite(img)):
                fail(f"{path} has {img.size} values or non-finite ones")
            imgs[path.name[:-len("_float32.bin")]] = img.reshape(1, n, n)
        hu = np.fromfile(acq / "recon_HU_float32.bin",
                         np.float32).reshape(1, n, n)
        rows.append(f"{spec} recon_HU {roi_mean(hu, 0, 0, 0, cfg.FOV):.2f}, "
                    f"water BHC {roi_mean(imgs['recon_waterBHC_HU'], 0, 0, 0, cfg.FOV):.2f}, "
                    f"bone BHC {roi_mean(imgs['recon_boneBHC_HU'], 0, 0, 0, cfg.FOV):.2f}, "
                    f"denoised {roi_mean(imgs['recon_denoised_HU'], 0, 0, 0, cfg.FOV):.2f}")
    print("  bladder ROI HU at (0, 0): " + "; ".join(rows))
    return 2 * (len(DENOISED_FILES) + len(BHC_FILES))


def composed_stage_profile(cfg, label, tmp, smi):
    """One more DE pair of a composed 2-D path (in-plane FFS or parallel
    beam), stage by stage, and the device's busy share over one more
    ``simulate_dect``."""
    import torch

    from dexct_tpu_torch.pipeline.api import get_recon, simulate_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.utils.io import StageWriter

    dev = torch.device("cuda")
    st = Stages()
    gens = default_generators()
    s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
    s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
    st.mark("spectra")
    cfg.ct.ray_geometry()
    st.mark("ray_geometry (alone)")
    if getattr(cfg.ct, "ffs", "none") != "none":
        from dexct_tpu_torch.ops.ffs import parallel_rebin_plan_ffs

        parallel_rebin_plan_ffs(cfg.ct)
        st.mark("FFS rebin plan (alone)")
    args = (cfg.ct, cfg.phantom, s1, s2, cfg.N_matrix, cfg.FOV, cfg.ramp)
    out = simulate_dect(*args, device=dev, n_iters=50, do_recon=False)
    st.mark("trace to decomposition (with its rays)")
    recons = [get_recon(x, cfg.ct, spec, cfg.N_matrix, cfg.FOV, cfg.ramp)
              for x, spec in ((out.sino_log[0], s1), (out.sino_log[1], s2),
                              (out.mat_sinos[0], None),
                              (out.mat_sinos[1], None))]
    st.mark("4 reconstructions" + (" (each with its FFS plan)"
                                   if label == "ffs" else ""))
    writer = StageWriter(str(tmp / f"{label}_profile"), cfg.run_id)
    for i, (sid_, dose) in enumerate((("detunedMV", 9.0), ("80kV", 1.0))):
        writer.acquisition(sid_, dose, sino_raw=out.sino_raw[i],
                           sino_log=out.sino_log[i], recon_raw=recons[i][0],
                           recon_HU=recons[i][1])
    writer.matdecomp("detunedMV", "80kV", 9.0, 1.0,
                     mat_sinos=list(out.mat_sinos),
                     mat_recons=[recons[2][0], recons[3][0]])
    st.mark("write the 12 files")
    del out, recons
    print_stages(label, st.t, lambda: simulate_dect(*args, device=dev,
                                                    n_iters=50), smi)


def bhc_denoise_stage_profile(cfg, smi):
    """One more DE pair of the --bhc --denoise path after its default
    step, stage by stage: the water BHC of both spectra, the two n_theta =
    768 Fourier plans of the bone BHC alone (host), the bone BHC of both
    spectra (with their plans), the denoiser (first call, then its forward
    pass on the card alone); the device's busy share over the BHC and
    denoising stages."""
    import numpy as np
    import torch

    from dexct_tpu_torch.learn.denoiser_io import denoise_hu_batch
    from dexct_tpu_torch.ops.bhc import bone_bhc_recon, water_bhc_recon
    from dexct_tpu_torch.ops.fourier import plan_fourier_projector
    from dexct_tpu_torch.physics.materials import AIR, WATER, MaterialTable
    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.system.phantom import VoxelPhantom

    dev = torch.device("cuda")
    st = Stages()
    gens = default_generators()
    specs = (_resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens),
             _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens))
    st.mark("spectra")
    arrays, meta = pack_dect(cfg.ct, cfg.phantom, *specs, cfg.N_matrix,
                             cfg.FOV, cfg.ramp, device=dev, n_iters=50,
                             projector="fourier", recon="parallel")
    st.mark("pack_dect")
    out = dect_step(arrays, meta)
    st.mark("dect_step")
    n, fov = cfg.N_matrix, cfg.FOV
    bhc_args = [(out["sino_log"][i], cfg.ct, specs[i], n, fov, cfg.ramp)
                for i in (0, 1)]
    for a in bhc_args:
        water_bhc_recon(*a)
    st.mark("water BHC x2")
    dummy = VoxelPhantom("bhc", np.zeros((n, n), np.uint8),
                         MaterialTable([AIR, WATER]), fov / n, fov / n,
                         fov / n)
    for _ in (0, 1):
        plan_fourier_projector(dummy, cfg.ct, n_theta=768, device=dev)
    st.mark("two n_theta=768 Fourier plans (alone)")
    for a in bhc_args:
        bone_bhc_recon(*a)
    st.mark("bone BHC x2 (with their plans)")
    batch = torch.cat([h.reshape(-1, n, n) for h in out["recon_HU"]])
    denoise_hu_batch(batch)
    st.mark("denoise (first call)")
    fwd = time_ms(lambda: denoise_hu_batch(batch), 5)
    print(f"  denoiser forward on {tuple(batch.shape)} float32 (cuDNN, TF32 "
          f"off; CUDA events, mean of 5): {fwd:.4f} ms")

    def post():
        for a in bhc_args:
            water_bhc_recon(*a)
            bone_bhc_recon(*a)
        denoise_hu_batch(batch)

    print_stages("bhc_denoise", st.t, post, smi)


STEP_TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
            "sino_log": dict(rtol=0.0, atol=1e-4),
            "mat_sinos": dict(rtol=0.0, atol=1e-3),
            "recon_raw": dict(rtol=0.0, atol=1e-4),
            "recon_HU": dict(rtol=0.0, atol=1.0),
            "mat_recons": dict(rtol=0.0, atol=1e-3)}


def close_outputs(got, want, label):
    """Fail unless two step outputs agree to the pipeline tolerances."""
    import torch

    for key, tol in STEP_TOL.items():
        for i in range(2):
            g, w = got[key][i], want[key][i].to(got[key][i].device)
            if not torch.allclose(g, w, **tol):
                fail(f"{label}: {key}[{i}] differs by "
                     f"{float((g - w).abs().max()):.6g}")


def zstack_path(records, work, smi):
    """Phase 4, z-stack through the library: pack_zstack + zstack_step at
    the z-stack workload (projector 'siddon', recon 'parallel', 50 GN
    iterations, the 8 slices in one chunk), twice, with the launch
    counters and the outputs checked: slices 0 and 7 equal single-slice
    dect_step runs, the air ROI reads ~-1000 HU on every slice."""
    import dataclasses

    import torch

    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.pipeline.zstack import (pack_zstack, stack_paths,
                                                 zstack_step)

    ct, ph, s1, s2 = work
    dev = torch.device("cuda")
    kw = dict(device=dev, n_iters=50, projector="siddon", recon="parallel")
    n_img, fov = 512, 50.0
    fns = zero_counters()
    walls = []
    for _ in (1, 2):
        t0 = time.perf_counter()
        arrays, meta, axes = pack_zstack(ct, ph, s1, s2, n_img, fov, 0.8,
                                         **kw)
        out = zstack_step(arrays, meta, axes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    nz = ph.labels.shape[0]
    print(f"zstack path (library, pack_zstack + zstack_step, {nz} slices): "
          f"{walls[0]:.3f} s (first), {walls[1]:.3f} s (steady, "
          f"{walls[1] / nz * 1e3:.1f} ms per slice) on {smi}")
    k17 = fns["siddon_trace_stack"].launches
    check_launches("zstack", fns, ZSTACK_KERNELS, records)
    if k17 != 2:
        fail(f"siddon_trace_stack launched {k17} times in 2 one-chunk runs")
    V, C = ct.N_proj, ct.N_channels
    for key in out:
        for i, x in enumerate(out[key]):
            shape = (nz, V, C) if "sino" in key else (nz, n_img, n_img)
            if tuple(x.shape) != shape:
                fail(f"zstack {key}[{i}] has shape {tuple(x.shape)}")
            if not bool(torch.isfinite(x).all()):
                fail(f"zstack {key}[{i}] holds non-finite values")
    air = [[roi_mean(out["recon_HU"][i], 0.0, -20.0, z, fov)
            for z in range(nz)] for i in (0, 1)]
    print("  air ROI HU at (0, -20) cm per slice: detunedMV "
          + ", ".join(f"{h:.2f}" for h in air[0]) + "; 80kV "
          + ", ".join(f"{h:.2f}" for h in air[1]))
    if not all(abs(h + 1000.0) <= 50.0 for row in air for h in row):
        fail(f"zstack air ROI is not ~-1000 HU: {air}")
    for z in (0, nz - 1):
        a1, m1 = pack_dect(ct, dataclasses.replace(ph, z_index=z), s1, s2,
                           n_img, fov, 0.8, **kw)
        ref = dect_step(a1, m1)
        close_outputs({k: (v[0][z], v[1][z]) for k, v in out.items()}, ref,
                      f"zstack slice {z} against its single-slice step")
    print(f"  slices 0 and {nz - 1} equal single-slice dect_step runs to the "
          "pipeline tolerances")
    del out
    st = Stages()
    arrays, meta, axes = pack_zstack(ct, ph, s1, s2, n_img, fov, 0.8, **kw)
    st.mark("pack_zstack")
    shared = {k: v for k, v in arrays.items() if axes[k] is None}
    stack_paths(shared, arrays["labels"], meta)
    st.mark(f"K17 trace of the {nz} slices (alone)")
    zstack_step(arrays, meta, axes)
    st.mark("zstack_step")
    print_stages("zstack", st.t, lambda: zstack_step(arrays, meta, axes), smi)


def helical_weightings_path(ccfg, spectra, records, smi, witness=None):
    """Phase 4, the gFDK study weightings through the library:
    ``pack_cone_dect(weighting=w)`` + ``cone_dect_step`` on the helical
    config for 'pair' (twice), 'td' and 'short', with the launch counters
    and the outputs checked: exact shapes, finite values, and the central
    slice's air and body ROIs within REF_TOL_HU of what the JAX package
    reads there in that weighting (WEIGHTING_REF_HU; these windows differ
    from 'full' near the FOV's edge).  With ``witness``, the log sinograms
    and each weighting's central slice (HU) go to
    ``witness/helical_weightings.npz`` for that comparison."""
    import numpy as np
    import torch

    from dexct_tpu_torch.pipeline.cone import cone_dect_step, pack_cone_dect

    ct = ccfg.ct
    dev = torch.device("cuda")
    fns = zero_counters()
    saved = {}
    for w, run in (("pair", 1), ("pair", 2), ("td", 1), ("short", 1)):
        st = Stages()
        arrays, meta = pack_cone_dect(
            ct, ccfg.phantom, *spectra(ct), ccfg.N_matrix, ccfg.FOV,
            ccfg.ramp, device=dev, n_iters=50, weighting=w)
        st.mark("pack_cone_dect")
        out = cone_dect_step(arrays, meta)
        st.mark("cone_dect_step")
        wall = sum(st.t.values()) / 1e3
        vols = out["recon_HU"]
        shape = (meta.nz_out, ccfg.N_matrix, ccfg.N_matrix)
        for key in out:
            for i, x in enumerate(out[key]):
                if not bool(torch.isfinite(x).all()):
                    fail(f"helical weighting {w}: {key}[{i}] holds "
                         "non-finite values")
        if tuple(vols[0].shape) != shape:
            fail(f"helical weighting {w}: volume shape {tuple(vols[0].shape)}")
        air = [roi_mean(v.cpu().numpy(), 0.0, -18.0, shape[0] // 2)
               for v in vols]
        body = [roi_mean(v.cpu().numpy(), 0.0, 0.0, shape[0] // 2)
                for v in vols]
        ref_air, ref_body = WEIGHTING_REF_HU[w]
        d = [got - ref for got, ref in zip(air + body, ref_air + ref_body)]
        print(f"helical weighting {w} (run {run}, library): wall per DE pair"
              f" {wall:.3f} s (pack {st.t['pack_cone_dect']:.1f} ms, step "
              f"{st.t['cone_dect_step']:.1f} ms) on {smi}; air ROI HU "
              f"{air[0]:.2f}, {air[1]:.2f}; body ROI HU {body[0]:.2f}, "
              f"{body[1]:.2f} (minus the reference's: air {d[0]:.2f}, "
              f"{d[1]:.2f}; body {d[2]:.2f}, {d[3]:.2f})")
        if not max(abs(x) for x in d) <= REF_TOL_HU:
            fail(f"helical weighting {w}: the air and body ROIs are {d} HU "
                 "off the reference's")
        if witness is not None and run == 1:
            saved[f"hu_{w}"] = torch.stack(
                [v[shape[0] // 2] for v in vols]).cpu().numpy()
            saved["sino_log"] = torch.stack(out["sino_log"]).cpu().numpy()
            saved["mu_w"] = np.array([meta.mu_w1, meta.mu_w2])
    check_launches("helical_weightings", fns, HELICAL_WEIGHTING_KERNELS,
                   records)
    if witness is not None:
        witness.mkdir(parents=True, exist_ok=True)
        np.savez(witness / "helical_weightings.npz", **saved)
        print(f"  wrote {witness / 'helical_weightings.npz'}")


def cone_pwls_path(ccfg, records, smi):
    """Phase 4, exact 3-D iterative reconstruction through the library on
    the cone config: the 60 keV sinogram from ``cone_material_paths``
    (K10), Poisson counts at PWLS_N0 per ray from a seeded generator, an
    FDK warm start (K11) on the phantom's voxel grid, ``cone_pwls_recon``
    (60 iterations, beta 3e-2; K18, K19) and ``cone_cg_recon`` (30
    iterations), twice, with the launch counters checked.  The bladder
    (water) ROI of the central slice must read mu_w within 5 % with a
    standard deviation below 0.6 x FDK's (the JAX package's
    test_cone_pwls_low_dose checks), and CG's residual must fall."""
    import torch

    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.ops.siddon import mono_sinogram

    ct, ph = ccfg.ct, ccfg.phantom
    dev = torch.device("cuda")
    shape = tuple(ph.labels.shape)
    vox = (ph.dx, ph.dy, ph.dz)
    n, fov = shape[-1], shape[-1] * ph.dx
    fns = zero_counters()

    def recons():
        x = conebeam.cone_pwls_recon(y, counts, ct, shape, vox, n_iters=60,
                                     beta=3e-2,
                                     x0=torch.clamp_min(fdk, 0.0))
        st.mark("cone_pwls_recon (60 iterations)")
        return (x, *conebeam.cone_cg_recon(y, ct, shape, vox, n_iters=30))

    for run in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = Stages()
        sino = mono_sinogram(conebeam.cone_material_paths(ph, ct, device=dev),
                             mono_mu(ph, dev))
        st.mark("cone_material_paths + mono_sinogram")
        gen = torch.Generator(device=dev).manual_seed(5)
        counts = torch.clamp_min(torch.poisson(
            PWLS_N0 * torch.exp(-sino), generator=gen), 1.0)
        y = -torch.log(counts / PWLS_N0)
        st.mark("Poisson counts")
        fdk = conebeam.fdk_reconstruct(y, ct, n, fov, ccfg.ramp,
                                       nz_out=shape[0], dz_out=ph.dz)
        st.mark("FDK warm start")
        x, vol_cg, hist = recons()
        st.mark("cone_cg_recon (30 iterations)")
        wall = sum(st.t.values()) / 1e3
        print(f"cone_pwls path (library, run {run}): {wall:.3f} s on {smi}; "
              "stages (ms): " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in st.t.items())
              + f"; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.4f} GB")
    builds = fns["cone_transpose"].launches
    check_launches("cone_pwls", fns, CONE_PWLS_KERNELS, records)
    if builds != 4:
        fail(f"K19's table was built {builds} times in two cone_pwls runs, "
             "not once per reconstruction")
    # K19's share of the reconstructions, from one more call profiled
    st = Stages()
    wall, dev_ms, _, top = profiled_run(recons, top=40)
    k19 = sum(ms for k, ms in top if "backproject_3d" in k)
    build = sum(ms for k, ms in top if "transpose" in k)
    print(f"  K19 table builds: {builds} (one per reconstruction); "
          f"profiled PWLS + CG: wall {wall:.1f} ms, device {dev_ms:.1f} ms, "
          f"K19's gathers {k19:.1f} ms and builds {build:.1f} ms, K19's "
          f"share {(k19 + build) / wall:.3f}")
    mu_w = float(mono_mu(ph, dev)[5])  # label 5: water (the bladder)
    # 2 cm x 2 cm inside the bladder (its centre lies at y = 1.8 cm)
    xr, fr = (roi_box(v, 0.0, 1.8, shape[0] // 2, fov, 1.0) for v in (x, fdk))
    bias = abs(float(xr.mean()) - mu_w) / mu_w
    ratio = float(xr.std()) / float(fr.std())
    h = hist.cpu()
    print(f"  bladder ROI: PWLS mean {float(xr.mean()):.5f} (mu_w {mu_w:.5f}"
          f", off {bias:.4f}; FDK mean {float(fr.mean()):.5f}), std "
          f"{float(xr.std()):.5f} = {ratio:.3f} x FDK's "
          f"{float(fr.std()):.5f}; CG residual {float(h[0]):.6g} -> "
          f"{float(h[-1]):.6g}; finite: "
          f"{bool(torch.isfinite(x).all() and torch.isfinite(vol_cg).all())}")
    if not (bias < 0.05 and ratio < 0.6 and float(h[-1]) < float(h[0])
            and bool(torch.isfinite(x).all())
            and bool(torch.isfinite(vol_cg).all())):
        fail("the cone PWLS/CG path misses its physics checks")


def helical_pi_path(ccfg, records, smi):
    """Phase 4, the cone-parallel PI method through the library on the
    helical config's 60 keV sinogram (K10, then ``helical_pi_reconstruct``:
    K5 at 4 taps, K20), twice, with the launch counters checked; finite
    values, and the bladder ROI within BODY_TOL_HU of the helical gFDK's
    (``helical_fdk_reconstruct`` on the same sinogram, run after the count)
    in 60 keV HU."""
    import torch

    from dexct_tpu_torch.ops import conebeam, helical_pi
    from dexct_tpu_torch.ops.siddon import mono_sinogram

    ct, ph = ccfg.ct, ccfg.phantom
    dev = torch.device("cuda")
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        sino = mono_sinogram(conebeam.cone_material_paths(ph, ct, device=dev),
                             mono_mu(ph, dev))
        st.mark("cone_material_paths + mono_sinogram")
        vol = helical_pi.helical_pi_reconstruct(sino, ct, ccfg.N_matrix,
                                                ccfg.FOV, ccfg.ramp)
        st.mark("helical_pi_reconstruct")
        print(f"helical_pi path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("helical_pi", fns, HELICAL_PI_KERNELS, records)
    ref = conebeam.helical_fdk_reconstruct(sino, ct, ccfg.N_matrix, ccfg.FOV,
                                           ccfg.ramp)
    mu_w = float(mono_mu(ph, dev)[5])
    hu = [(1000.0 * (v - mu_w) / mu_w).cpu().numpy() for v in (vol, ref)]
    iz = vol.shape[0] // 2
    body = [roi_mean(h, 0.0, 0.0, iz) for h in hu]
    air = [roi_mean(h, 0.0, -18.0, iz) for h in hu]
    print(f"  {vol.shape[0]} slices; bladder ROI HU (60 keV): PI "
          f"{body[0]:.2f}, gFDK {body[1]:.2f}; air ROI HU: PI {air[0]:.2f}, "
          f"gFDK {air[1]:.2f}")
    if not (bool(torch.isfinite(vol).all())
            and abs(body[0] - body[1]) <= BODY_TOL_HU
            and abs(air[0] + 1000.0) <= 50.0):
        fail("the helical PI path misses its checks")


def recon_grid(cfg):
    """The reference protocol's reconstruction grid (N_matrix^2 over the
    FOV) as an empty phantom: the domain of the one-step path's Fourier
    plan."""
    import numpy as np

    from dexct_tpu_torch.system.phantom import VoxelPhantom

    n, px = cfg.N_matrix, cfg.FOV / cfg.N_matrix
    return VoxelPhantom("recon_grid", np.zeros((1, n, n), np.uint8),
                        cfg.phantom.materials, px, px, px)


def autograd_adjoint(A, n):
    """A^T of a linear image -> sinogram operator by autograd: a forward
    pass at zero, then its backward (K7 and K8, then K22 and K21)."""
    import torch

    def adjoint(y):
        x = torch.zeros((n, n), device=y.device, requires_grad=True)
        (g,) = torch.autograd.grad(A(x), x, y)
        return g

    return adjoint


def fourier_adjoint_kernel_phase(cfg, records, dev):
    """Phase 3, the Fourier projector's adjoints, at the plans the paths
    run them on: the reference protocol's phantom grid (256^2 at 0.2 cm, G
    = 512, n_theta = 1024, 1000 x 800 rays; one image, as the 2-D
    iterative path runs them; recorded) and the one-step path's 512^2
    reconstruction grid over 50 cm (G = 1024, 1024 x 513 samples; two basis
    images); K21 also at the motion joint fit's (the same grid at n_theta
    = 512, one image).  At each, K21 and K22 against their plain versions
    (1e-5 x max), bit for bit against the CPU's ``index_add_`` and two
    launches against each other, and, through the dot-product identity,
    against K7 and K8 (1e-5); each one's transposed taps built once (host
    clock) and its device time (CUDA graph); at the reference plan <A x,
    y> = <x, A^T y> for the whole chain, and one A^T explicit (K22, the FFT
    chain's adjoint, K21) against autograd's (a forward pass, then its
    backward).  The library yardsticks are the transposed tap matrices as
    CSR products (complex for K21)."""
    import torch

    from dexct_tpu_torch.ops import fourier, iterative
    from dexct_tpu_torch.tools import probe_kb_adjoint

    gen = torch.Generator(device=dev).manual_seed(7)

    def crandn(shape):
        return torch.complex(*(torch.randn(shape, generator=gen, device=dev)
                               for _ in range(2)))

    def rdot(a, b):
        return float((torch.view_as_real(a).double()
                      * torch.view_as_real(b).double()).sum())

    def check_k21(plan, M, label, record):
        G = plan.grid
        tabs = (plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
        g = crandn((M,) + tuple(plan.phase_cos.shape))
        # the plan's transposed taps, built once (host clock, synchronised)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kb_t = fourier.kb_transpose(plan)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        F_adj, want, ms, pms = compare(
            lambda: fourier.kb_sample_adjoint(g, *tabs, G, kb_t=kb_t),
            lambda: fourier.kb_sample_adjoint_plain(g, *tabs, G), reps=5)
        err, big = max_err(F_adj, want)
        again = fourier.kb_sample_adjoint(g, *tabs, G, kb_t=kb_t)
        if not torch.equal(again, F_adj):
            fail("two launches of K21 differ")
        cpu = fourier.kb_sample_adjoint_plain(g.cpu(),
                                              *(t.cpu() for t in tabs), G)
        if not torch.equal(F_adj.cpu(), cpu):
            fail(f"K21 is not bit-equal to the CPU's index_add_ ({label}; "
                 f"max diff {max_err(F_adj.cpu(), cpu)[0]:.3g})")
        del cpu
        per_call_ms = time_ms(
            lambda: fourier.kb_sample_adjoint(g, *tabs, G), 3)
        dev_ms = graph_ms(
            lambda: fourier.kb_sample_adjoint(g, *tabs, G, kb_t=kb_t))
        # the rows over 256 taps alone (the cells around DC), the others
        # empty: the in-order sums' longest chains
        long_t, n_long, _ = probe_kb_adjoint.long_rows(fourier, kb_t, G * G)
        long_ms = graph_ms(
            lambda: fourier.kb_sample_adjoint(g, *tabs, G, kb_t=long_t))
        del long_t
        t_bytes = nbytes(kb_t.row_ptr, kb_t.entries, kb_t.rows, kb_t.ell,
                         kb_t.ell_offset)
        print(f"  kb_sample_adjoint ({label}): transpose built in "
              f"{build_ms:.3f} ms (host clock; {t_bytes} B, "
              f"{kb_t.entries.shape[0]} taps, {kb_t.n_long} rows a warp "
              f"each), K21's device time {dev_ms:.4f} ms (CUDA graph of 20 "
              f"calls), the {n_long} rows over 256 taps "
              f"alone {long_ms:.4f} ms, with a transpose built per call "
              f"{per_call_ms:.4f} ms; two launches bitwise equal; bit-equal "
              f"to the CPU index_add_: yes")
        F = crandn((M, G, G))
        lhs, rhs = rdot(fourier.kb_sample(F, *tabs), g), rdot(F, F_adj)
        ident = abs(lhs - rhs) / abs(lhs)
        S = plan.slice_idx.numel()
        phase = torch.complex(plan.phase_cos.reshape(-1),
                              plan.phase_sin.reshape(-1))
        vals = plan.slice_w.reshape(S, 16).to(torch.complex64) \
            * phase.conj()[:, None]
        Wh = sparse_taps(
            fourier._window_indices(plan.slice_idx, G).reshape(-1),
            torch.arange(S, device=dev).repeat_interleave(16),
            vals.reshape(-1), (G * G, S))
        gcol = g.reshape(M, S).T.contiguous()
        lib_err = float((torch.sparse.mm(Wh, gcol).T.reshape(F_adj.shape)
                         - want).abs().max())
        report(records, "kb_sample_adjoint", err, ms, pms,
               err <= 1e-5 * big and ident <= 1e-5,
               (nbytes(g, *tabs, F_adj), S * M * 70),
               library_ms=time_ms(lambda: torch.sparse.mm(Wh, gcol), 5),
               extra=f" ({label}; max |plain| {big:.6g}; <K7 F, g> = "
                     f"{lhs:.8g}, <F, K21 g> = {rhs:.8g}, rel {ident:.3g}; "
                     f"complex CSR library err {lib_err:.3g})",
               record=record)
        return g

    def check_k22(plan, M, label, record):
        vs = (cfg.ct.N_proj, cfg.ct.N_channels)
        radon_shape = (M, plan.n_theta, plan.nt)
        y = torch.randn(vs + (M,), generator=gen, device=dev)
        # the plan's transposed taps, built once (host clock, synchronised)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fan_t = fourier.fan_transpose(plan)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        r_adj, want, ms, pms = compare(
            lambda: fourier.resample_to_fan_adjoint(
                y, plan.fan_idx, plan.fan_w, radon_shape, fan_t=fan_t),
            lambda: fourier.resample_to_fan_adjoint_plain(
                y, plan.fan_idx, plan.fan_w, radon_shape), reps=5)
        err, big = max_err(r_adj, want)
        again = fourier.resample_to_fan_adjoint(
            y, plan.fan_idx, plan.fan_w, radon_shape, fan_t=fan_t)
        if not torch.equal(again, r_adj):
            fail("two launches of K22 differ")
        per_call_ms = time_ms(lambda: fourier.resample_to_fan_adjoint(
            y, plan.fan_idx, plan.fan_w, radon_shape), 3)
        dev_ms = graph_ms(lambda: fourier.resample_to_fan_adjoint(
            y, plan.fan_idx, plan.fan_w, radon_shape, fan_t=fan_t))
        cpu = fourier.resample_to_fan_adjoint_plain(
            y.cpu(), plan.fan_idx.cpu(), plan.fan_w.cpu(), radon_shape)
        same_as_cpu = torch.equal(r_adj.cpu(), cpu)
        del cpu
        r = torch.randn(radon_shape, generator=gen, device=dev)
        lhs = float((fourier.resample_to_fan(r, plan.fan_idx, plan.fan_w,
                                             vs + (M,)).double()
                     * y.double()).sum())
        rhs = float((r.double() * r_adj.double()).sum())
        ident = abs(lhs - rhs) / abs(lhs)
        idx = plan.fan_idx.reshape(-1, 4).to(torch.int64)
        n_rays = idx.shape[0]
        n_bins = plan.n_theta * plan.nt
        Wt = sparse_taps(
            idx.reshape(-1),
            torch.arange(n_rays, device=dev).repeat_interleave(4),
            plan.fan_w.reshape(-1), (n_bins, n_rays))
        ycol = y.reshape(n_rays, M)
        lib_err = float((torch.sparse.mm(Wt, ycol).T.reshape(radon_shape)
                         - want).abs().max())
        print(f"  resample_to_fan_adjoint ({label}): transpose built in "
              f"{build_ms:.3f} ms (host clock; row_ptr {nbytes(fan_t[0])} B, "
              f"ray and w {nbytes(*fan_t[1:])} B), K22's device time "
              f"{dev_ms:.4f} ms (CUDA graph of 20 calls), with a transpose "
              f"built per call {per_call_ms:.4f} ms; two launches bitwise "
              f"equal; bit-equal to the CPU index_add_: "
              f"{'yes' if same_as_cpu else 'no'}")
        report(records, "resample_to_fan_adjoint", err, ms, pms,
               err <= 1e-5 * big and ident <= 1e-5,
               (nbytes(y, plan.fan_idx, plan.fan_w, r_adj), n_rays * M * 8),
               library_ms=time_ms(lambda: torch.sparse.mm(Wt, ycol), 5),
               extra=f" ({label}; max |plain| {big:.6g}; <K8 r, y> = "
                     f"{lhs:.8g}, <r, K22 y> = {rhs:.8g}, rel {ident:.3g}; "
                     f"CSR library err {lib_err:.3g})",
               record=record)

    plan = fourier.plan_fourier_projector(cfg.phantom, cfg.ct, device=dev)
    vs = (cfg.ct.N_proj, cfg.ct.N_channels)
    G = plan.grid
    # K21: 1024 x 257 samples into the G = 512 spectrum
    g = check_k21(plan, 1, "reference plan, 1 image", True)
    # the DC hot spot: every line's l = 0 and l = 1 windows add into the
    # same 16 cells; the same launch without those 2 n_theta samples (over
    # their own transpose, built once)
    S = plan.slice_idx.numel()
    nth, nl = plan.phase_cos.shape
    cut = (g[:, :, 2:].contiguous(),
           plan.slice_idx.reshape(nth, nl)[:, 2:].contiguous(),
           plan.slice_w.reshape(nth, nl, 16)[:, 2:].contiguous(),
           plan.phase_cos[:, 2:].contiguous(),
           plan.phase_sin[:, 2:].contiguous())
    cut_t = fourier._kb_transpose_taps(cut[1], cut[2], G)
    cut_ms = time_ms(lambda: fourier.kb_sample_adjoint(*cut, G, kb_t=cut_t),
                     5)
    print(f"  kb_sample_adjoint without the l < 2 samples ({2 * nth} of {S}):"
          f" {cut_ms:.4f} ms")
    del cut, cut_t
    # K22: 8e5 fan rays into the 1024 x 1024 Radon transform
    check_k22(plan, 1, "reference plan, 1 image", True)

    # the whole projector: <A x, y> = <x, A^T y>
    A = iterative.make_projection_operator(plan, vs)
    At = iterative._projection_adjoint(plan, vs)
    x = torch.randn((plan.n_img, plan.n_img), generator=gen, device=dev)
    y2 = torch.randn(vs, generator=gen, device=dev)
    lhs = float((A(x).double() * y2.double()).sum())
    rhs = float((x.double() * At(y2).double()).sum())
    ident = abs(lhs - rhs) / abs(lhs)
    print(f"  Fourier projector A (K7, K8) and A^T (K22, K21) at "
          f"{plan.n_img}^2, {vs[0]} x {vs[1]} rays: <A x, y> = {lhs:.8g}, "
          f"<x, A^T y> = {rhs:.8g}, rel {ident:.3g} [<= 1e-5]")
    if not ident <= 1e-5:
        fail("the Fourier projector's adjoint fails the dot-product "
             "identity")
    At_auto = autograd_adjoint(A, plan.n_img)
    err, big = max_err(At_auto(y2), At(y2))
    t_exp, t_auto = [time_ms(lambda: At(y2), 10)], []
    t_auto += [time_ms(lambda: At_auto(y2), 10) for _ in range(2)]
    t_exp.append(time_ms(lambda: At(y2), 10))
    print(f"  one A^T at the reference plan: explicit (K22, FFT adjoints, "
          f"K21) {sum(t_exp) / 2:.4f} ms, autograd's (K7, K8, then K22, "
          f"K21) {sum(t_auto) / 2:.4f} ms, A alone "
          f"{time_ms(lambda: A(x), 10):.4f} ms; the two A^T differ by "
          f"{err:.3g} (max {big:.6g}) [<= 1e-5 x max]")
    if not err <= 1e-5 * big:
        fail("the explicit A^T and autograd's differ")
    del plan, A, At, At_auto

    # the one-step path's plan: K21 and K22 on two basis images
    plan = fourier.plan_fourier_projector(recon_grid(cfg), cfg.ct,
                                          device=dev)
    label = (f"one-step plan, {plan.n_img}^2 grid, G = {plan.grid}, "
             "2 images")
    check_k21(plan, 2, label, False)
    check_k22(plan, 2, label, False)
    del plan

    # the motion joint fit's plan (estimate_motion_joint's n_theta = 512):
    # K21 on one image
    plan = fourier.plan_fourier_projector(recon_grid(cfg), cfg.ct,
                                          n_theta=512, device=dev)
    check_k21(plan, 1, f"motion plan, G = {plan.grid}, n_theta 512, 1 image",
              False)


def dose_work(args, three_d):
    """Bytes and float32 operations of one dose accumulation on this run's
    inputs: each input and the dose map moved once; per (voxel, view) in
    the beam (and, in 3-D, in the view's z slab) one exp and K + 2
    operations per live energy, and per polar sample 20 (2-D) or 35 (3-D)
    for its corners and running sum."""
    import torch

    from dexct_tpu_torch.ops import dose

    if three_d:
        (labels, mu, mu_dep, i0w, betas, src_zs, vw, gammas, ts, rs, vox,
         rho, lab, scal, z_window) = args
    else:
        (labels, mu, mu_dep, i0w, betas, vw, gammas, rs, vox, rho, lab,
         scal) = args
    K, E = mu.shape
    sid = torch.tensor(float(scal[0]), device=vox.device)
    src, _, _ = dose._view_trig(betas, gammas, sid)
    pairs = 0
    if three_d:
        nz, ny, nx = labels.shape
        k0s, depth = dose._z_slabs(src_zs, ts, rs, vox[0, 2],
                                   torch.tensor(float(scal[3]),
                                                device=vox.device),
                                   nz, z_window)
        kz = torch.arange(vox.shape[0], device=vox.device) // (ny * nx)
    for v in range(betas.shape[0]):
        rel = vox[:, :2] - src[v][None, :]
        r_v = torch.sqrt((rel * rel).sum(-1))
        d0 = -src[v] / sid
        g_v = torch.atan2(d0[0] * rel[:, 1] - d0[1] * rel[:, 0],
                          rel[:, 0] * d0[0] + rel[:, 1] * d0[1])
        ok = torch.abs(g_v) <= float(scal[5 if three_d else 4])
        if three_d:
            t_v = (vox[:, 2] - src_zs[v]) / r_v
            ok &= (torch.abs(t_v) <= float(scal[6])) & (kz >= k0s[v]) & (
                kz < k0s[v] + depth)
        pairs += int(ok.sum())
    n_polar = betas.shape[0] * gammas.shape[0] * rs.shape[0] * (
        ts.shape[0] if three_d else 1)
    n_bytes = sum(nbytes(t) for t in args if torch.is_tensor(t)) \
        + 4 * vox.shape[0]
    return n_bytes, pairs * E * (K + 3) + n_polar * (35 if three_d else 20)


def dose_kernel_phase(cfg, cone_cfgs, spectra, records, dev):
    """Phase 3, the dose kernels against their plain versions on the
    spectra the dose path runs: K23 on input/params.txt's pelvis at every
    10th of its 1000 views, for both acquisitions (detunedMV, 100 live
    energy bins; 80 kV, 74, recorded), K24 at 80 kV on the cone config at
    every 30th of its 360 views and on the helical config (its z-slab
    window) at every 60th of its 720; dose 1e-4 of the map's maximum,
    deposited energy rel 1e-4.  K24 is profiled once more at each shape:
    its device time by kernel and the peak memory above its inputs."""
    from dexct_tpu_torch.ops import dose

    def check(name, args, fn, plain, three_d, label, record):
        (d, e), (dw, ew), ms, pms = compare(lambda: fn(*args),
                                            lambda: plain(*args), reps=1)
        err, big = max_err(d, dw)
        rel_e = abs(e - ew) / abs(ew)
        report(records, name, err, ms, pms,
               err <= 1e-4 * big and rel_e <= 1e-4, dose_work(args, three_d),
               extra=f" ({label}; {args[1].shape[1]} live energies; max "
                     f"|plain| {big:.6g} keV/g; deposited {e:.8g} vs "
                     f"{ew:.8g} keV, rel {rel_e:.3g})", record=record)

    def split(label, args):
        """K24's device time by kernel over one more call under
        torch.profiler, and the call's peak device memory above its
        inputs (the scratch, with the dose map and its slots)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dose._dose_accumulate_3d(*args)
            torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 1e9
        per = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us:
                per.append((e.key, e.count, float(us) / 1e3))
        per.sort(key=lambda kv: -kv[2])
        print(f"    K24 split ({label}; one call, torch.profiler): "
              + ", ".join(f"{k[:48]} x{n} {ms:.4f} ms" for k, n, ms in per)
              + f"; device total {sum(ms for *_, ms in per):.4f} ms; peak "
              f"above the inputs {extra:.4f} GB")

    ct = cfg.ct
    for i, spec in enumerate(spectra(ct)):
        args, _ = dose._dose_prep(
            cfg.phantom, ct, spec, n_gamma=None, n_r=None, oversample=2,
            views=ct.betas[::10], z_index=None, n_energy=None,
            view_weights=None, scoring="removed", device=dev)
        check("dose_map", args, dose._dose_accumulate,
              dose._dose_accumulate_plain, False,
              f"{len(ct.betas[::10])} views, {spec.name}", i == 1)
    for label, every in (("cone", 30), ("helical", 60)):
        ccfg = cone_cfgs[label]
        spec = spectra(ccfg.ct)[1]
        args, _ = dose._dose_prep_3d(
            ccfg.phantom, ccfg.ct, spec, n_gamma=None, n_t=None, n_r=None,
            oversample=2, views=None, n_energy=None, view_weights=None,
            scoring="removed", z_window="auto", device=dev)
        args = list(args)
        for i in (4, 5, 6):  # betas, source z, view weights
            args[i] = args[i][::every].contiguous()
        check("dose_map_3d", args, dose._dose_accumulate_3d,
              dose._dose_accumulate_3d_plain, True,
              f"{label} config, every {every}th view, z window "
              f"{args[-1]}, {spec.name}", label == "cone")
        split(f"{label} config, {args[4].shape[0]} views", args)


def noise_fields(counts, cov, ct, dev):
    """The filtered (r0, r1) [F, V, C] of the noise-map path: the 80 kV
    log variance (F = 1) or the three basis covariance fields (F = 3)."""
    import torch

    from dexct_tpu_torch.ops import noisemap

    if cov is None:
        fields = noisemap.log_variance(counts)[None]
    else:
        fields = torch.stack([cov[..., 0, 0], cov[..., 1, 1],
                              cov[..., 0, 1]])
    k0, k1, m, w_pre = noisemap._variance_filters(ct, 0.8, "sinc",
                                                  torch.float32, dev)
    r0, r1 = noisemap._cov_filter(fields * w_pre, k0, k1, m, ct.dgamma)
    return r0.contiguous(), r1.contiguous()


def k25_work(r0, r1, betas, ct, n, fov):
    """Bytes and float32 operations of one K25 call on this run's inputs:
    r0, r1, the angles and the maps moved once; per (pixel, view) 12
    operations up to the fan test (atan2 one), and inside the fan 16 more
    for the taps' weights and 1/l2^2 plus 8 per field."""
    import torch

    from dexct_tpu_torch.ops.fbp_fast import _pixel_coords

    F, V, C = r0.shape
    X, Y = _pixel_coords(n, fov, torch.float32, r0.device)
    inside = 0
    for v0 in range(0, V, 50):
        b = betas[v0:v0 + 50, None]
        vr = X[None] * torch.cos(b) + Y[None] * torch.sin(b) - ct.SID
        vt = -X[None] * torch.sin(b) + Y[None] * torch.cos(b)
        c = torch.atan2(-vt, -vr) / ct.dgamma - 0.5 + C / 2.0
        inside += int(((c >= 0) & (c <= C - 1)).sum())
    n_bytes = nbytes(r0, r1, betas) + 4 * F * n * n
    return n_bytes, V * n * n * 12 + inside * (16 + 8 * F)


def noise_kernel_phase(cfg, spectra, records, dev):
    """Phase 3, K25 against its plain version at the reference protocol
    (1000 views x 800 channels -> 512^2 over 50 cm): on the 80 kV
    acquisition's exact-path counts (K1, K2) with one field (recorded), and
    on the three basis covariance fields of its decomposition (K3) with
    three; 1e-5 x max |plain| (float32 sums over views in another order)."""
    import torch

    from dexct_tpu_torch.ops import matdecomp, noisemap, spectral
    from dexct_tpu_torch.ops.siddon import material_path_sinogram

    ct, n, fov = cfg.ct, cfg.N_matrix, cfg.FOV
    s1, s2 = spectra(ct)
    paths = material_path_sinogram(cfg.phantom, ct, device=dev)
    c1, _ = spectral.forward_counts(paths, cfg.phantom, s1, ct)
    c2, _ = spectral.forward_counts(paths, cfg.phantom, s2, ct)
    m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=50)
    cov = noisemap.decomposition_covariance(torch.stack([m1, m2], -1), ct,
                                            s1, s2)
    betas = torch.as_tensor(ct.betas, dtype=torch.float32, device=dev)
    dbeta = float(ct.rotation_total) / ct.N_proj
    for fields, label in ((None, "80 kV log variance"),
                          (cov, "basis covariance, 3 fields")):
        r0, r1 = noise_fields(c2, fields, ct, dev)
        args = (r0, r1, betas, ct.SID, ct.dgamma, n, fov)
        got, want, ms, pms = compare(
            lambda: noisemap._fan_backproject_var(*args, dbeta=dbeta),
            lambda: noisemap._fan_backproject_var_plain(*args, dbeta),
            reps=3)
        err, big = max_err(got, want)
        report(records, "fan_backproject_var", err, ms, pms,
               err <= 1e-5 * big, k25_work(r0, r1, betas, ct, n, fov),
               extra=f" ({label}; max |plain| {big:.6g} cm^-2)",
               record=fields is None)


def scatter_work(args, kw, cone):
    """Bytes and float32 operations of one K26/K27 call on this run's
    inputs: each input and the [V, D] output moved once; per march step
    (s_in from the source to each illuminated vertex, s_out from it to
    each element) 12 operations (14 in 3-D) for the sample point and
    weights and 4 (8) corners x (K + 3); per illuminated (vertex, energy)
    K + 4 with one exp; per (vertex, element) 40 for the geometry and per
    energy bin 4K + 26 for the Compton term (one exp) and 4K + 21 more for
    the Rayleigh term (one exp)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import scatter_physics as sp

    (labels, ne_w, f2w, cells, mu_gE, _, _, _, n0_g, betas, det_ga,
     scalars) = args
    K, G = mu_gE.shape
    sc, _ = sp._scatter_scalars(scalars, cone)
    src, d0, det, _ = sp._view_geometry(betas, det_ga, sc["sid"], sc["sdd"],
                                        cone)
    # the illuminated vertices (col > 0, the ones the exit stage visits),
    # from the plain version's own gate
    lit = sum(int((sp._incident_plain(labels, cells, ne_w, src[v], d0[v],
                                      mu_gE, n0_g, sc, kw["s_in"],
                                      kw["n_mats"], cone)[3] > 0).sum())
              for v in range(betas.shape[0]))
    corners, step = (8, 14) if cone else (4, 12)
    per_step = step + corners * (K + 3)
    D = det.shape[1]
    per_pair = (kw["s_out"] * per_step + 40
                + G * ((4 * K + 26) + kw["coherent"] * (4 * K + 21)))
    ops = lit * (kw["s_in"] * per_step + G * (K + 4)) + lit * D * per_pair
    n_bytes = sum(nbytes(t) for t in args if torch.is_tensor(t)) \
        + 4 * betas.shape[0] * D
    return n_bytes, float(np.float64(ops))


def scatter_args(cone, phantom, ct, spec, views, dev):
    """The tensors K26 (or K27) takes on the scatter path: the JAX study's
    settings (FAN_SCATTER, CONE_SCATTER) on ``views``."""
    from dexct_tpu_torch.ops import scatter_physics as sp

    if cone:
        args, kw, _ = sp._conebeam_prep(
            phantom, ct, spec, n_fine=96, s_in=None, s_out=None, views=views,
            coherent=True, n_q=48, device=dev, **CONE_SCATTER)
    else:
        args, kw, _ = sp._sinogram_prep(
            phantom, ct, spec, n_fine=96, s_in=None, s_out=None, views=views,
            z_index=None, coherent=True, n_q=48, device=dev, **FAN_SCATTER)
    return args, kw


def scatter_kernel_phase(cfg, cone_cfgs, spectra, records, dev):
    """Phase 3, K26 and K27 against their plain versions at the scatter
    path's shapes: K26 on both acquisitions of input/params.txt (every
    50th of the 1000 views, 4096 vertices, 101 channels, 12 energies, s_in
    128, s_out 64; 80 kV recorded), K27 on the cone config at 80 kV (every
    45th of 360 views, 4096 vertices, 33 x 5 elements, 8 energies); each
    plain version on 2 of those views (PLAIN_VIEWS), within 1e-4 x max
    |plain| (float32 sums over vertices, energies and march steps in
    another order); both kernels repeat bitwise.  Then the N_rows = 1
    anchor: K27 on a one-row cone through the cone config's central slice
    extruded over its 32 slices against K26 on that slice, the median
    relative difference over the channels above 20 % of the maximum within
    5 % (tests/test_scatter_physics.py:236)."""
    import dataclasses

    import numpy as np

    from dexct_tpu_torch.ops import scatter_physics as sp

    jobs = [(False, cfg.phantom, cfg.ct, s, cfg.ct.betas[::FAN_SCATTER_EVERY],
             f"{s.name}, fan", i == 1)
            for i, s in enumerate(spectra(cfg.ct))]
    ccfg = cone_cfgs["cone"]
    jobs.append((True, ccfg.phantom, ccfg.ct, spectra(ccfg.ct)[1],
                 ccfg.ct.betas[::CONE_SCATTER_EVERY], "80kV, cone config",
                 True))
    for cone, ph, ct, spec, views, label, record in jobs:
        args, kw = scatter_args(cone, ph, ct, spec, views, dev)
        plain_args = list(args)
        plain_args[9] = args[9][PLAIN_VIEWS].contiguous()
        fn = sp._scatter_scan_cone if cone else sp._scatter_scan
        got, want, ms, pms = compare(
            lambda: fn(*args, **kw),
            lambda: sp._scatter_plain(*plain_args, **kw, cone=cone,
                                      x_block=1024, d_block=32), reps=1)
        again = fn(*args, **kw)
        err, big = max_err(got[PLAIN_VIEWS], want)
        same = bool((again == got).all())
        name = "single_scatter_conebeam" if cone else "single_scatter"
        report(records, name, err, ms, pms, err <= 1e-4 * big and same,
               scatter_work(args, kw, cone),
               extra=f" ({label}; {got.shape[0]} views x {got.shape[1]} "
                     f"elements, {args[1].shape[0]} vertices, "
                     f"{args[4].shape[1]} energies, s_in {kw['s_in']}, s_out "
                     f"{kw['s_out']}; plain on {len(PLAIN_VIEWS)} views; max "
                     f"|plain| {big:.6g}; repeats bitwise: {same})",
               record=record)
    # the N_rows = 1 anchor on the cone config's central slice
    mid = ccfg.phantom.labels[ccfg.phantom.labels.shape[0] // 2]
    ph3 = dataclasses.replace(ccfg.phantom, labels=np.broadcast_to(
        mid, ccfg.phantom.labels.shape).copy())
    ph2 = dataclasses.replace(ccfg.phantom, labels=mid[None].copy())
    one_row = dataclasses.replace(ccfg.ct, N_rows=1)
    spec = spectra(one_row)[1]
    views = ccfg.ct.betas[::CONE_SCATTER_EVERY][:2]
    s3 = sp.single_scatter_conebeam(ph3, one_row, spec, views=views,
                                    device=dev, **CONE_SCATTER)[:, 0]
    fan = dict(CONE_SCATTER)
    del fan["row_sub"]
    s2 = sp.single_scatter_sinogram(ph2, one_row, spec, views=views,
                                    device=dev, **fan)
    sel = s2 > 0.2 * s2.max()
    rel = float(np.median(np.abs(s3[sel] - s2[sel]) / s2[sel]))
    print(f"  N_rows = 1 anchor: K27 vs K26 on the central slice, median "
          f"relative difference {rel:.4g} over {int(sel.sum())} channels "
          "[< 0.05]")
    if not rel < 0.05:
        fail("the one-row cone scatter misses the fan estimator")


def body_pixels(phantom, n, fov):
    """Image pixels (n^2 over fov cm) whose phantom voxel and every voxel
    within 1 cm of it are body (not air, label 0): the interior where the
    noise map is compared."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    lab = phantom.slice_labels()
    r = max(1, int(round(1.0 / phantom.dx)))
    air = torch.as_tensor((lab == 0).astype(np.float32))[None, None]
    near_air = F.max_pool2d(air, 2 * r + 1, stride=1, padding=r)[0, 0]
    c = (np.arange(n) + 0.5 - n / 2) * (fov / n)
    iy = np.floor(c / phantom.dy + lab.shape[0] / 2).astype(int)
    ix = np.floor(c / phantom.dx + lab.shape[1] / 2).astype(int)
    ok_y = (iy >= 0) & (iy < lab.shape[0])
    ok_x = (ix >= 0) & (ix < lab.shape[1])
    sel = np.zeros((n, n), bool)
    sub = near_air.numpy()[np.clip(iy, 0, lab.shape[0] - 1)][
        :, np.clip(ix, 0, lab.shape[1] - 1)] == 0
    sel[np.ix_(ok_y, ok_x)] = sub[np.ix_(ok_y, ok_x)]
    return torch.as_tensor(sel)


def noise_ensemble(counts, ct, spec, n, fov, dev):
    """Unbiased per-pixel variance [n, n] of NOISE_REALISATIONS Poisson
    draws of ``counts`` (a seeded torch.Generator on the card), each
    reconstructed by the port's fan FBP (K4)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.ops.fbp import fbp_recon

    air = float(np.sum(spectral.effective_fluence(spec, ct)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(64)
    s1 = torch.zeros((n, n), dtype=torch.float64, device=dev)
    s2 = torch.zeros_like(s1)
    for _ in range(NOISE_REALISATIONS):
        noisy = spectral.sample_noise(gen, counts, "poisson")
        img, _ = fbp_recon(spectral.log_sinogram(noisy, air), ct, n, fov,
                           0.8)
        img = img.to(torch.float64)
        s1 += img
        s2 += img * img
    m = NOISE_REALISATIONS
    return (s2 - s1 * s1 / m) / (m - 1)


def noise_map_path(cfg, spectra, records, smi, dev):
    """Phase 4, protocol noise prediction through the library on the
    reference protocol, twice with the launch counters checked: the exact
    paths (K1), both acquisitions' counts (K2) and their decomposition (K3,
    50 iterations), ``fbp_variance_map`` of both acquisitions (K25),
    ``decomposition_covariance`` (its peak device memory printed),
    ``basis_variance_maps`` (K25 with three fields) and
    ``vmi_variance_map`` from 40 to 300 keV.  Check 1: the 80 kV map
    against the variance of NOISE_REALISATIONS Poisson draws reconstructed
    by the fan FBP (K4): the median of predicted / empirical inside the
    body (1 cm from air) within 10 % of 1 (the JAX test's 8 % at 160
    draws, tests/test_noisemap.py:28-70).  Check 2: the VMI noise curve
    (median over the body) falls over 40-VMI_MONOTONE_KEV keV and has its
    minimum strictly inside 40-300 keV (the negative basis covariance at
    work; VMI_KEV says why not 40-140) and within VMI_MIN_TOL_KEV of the JAX
    package's VMI_MIN_KEV; every map finite and positive in the body."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import matdecomp, noisemap, spectral
    from dexct_tpu_torch.ops.siddon import material_path_sinogram

    ct, ph, n, fov = cfg.ct, cfg.phantom, cfg.N_matrix, cfg.FOV
    s1, s2 = spectra(ct)
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        paths = material_path_sinogram(ph, ct, device=dev)
        st.mark("K1 trace")
        c1, _ = spectral.forward_counts(paths, ph, s1, ct)
        c2, _ = spectral.forward_counts(paths, ph, s2, ct)
        st.mark("counts")
        m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2,
                                               n_iters=50)
        st.mark("decomposition")
        var = [noisemap.fbp_variance_map(c, ct, n, fov, 0.8)
               for c in (c1, c2)]
        st.mark("fbp_variance_map x2")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cov = noisemap.decomposition_covariance(
            torch.stack([m1, m2], -1), ct, s1, s2)
        st.mark("decomposition_covariance")
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        maps = noisemap.basis_variance_maps(cov, ct, n, fov, 0.8)
        st.mark("basis_variance_maps")
        vmi = torch.stack([noisemap.vmi_variance_map(*maps, e)
                           for e in VMI_KEV])
        st.mark("VMI curve")
        print(f"noise_map path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items())
              + f"; covariance peak above its inputs {peak:.3f} GB")
    t0 = time.perf_counter()
    emp = noise_ensemble(c2, ct, s2, n, fov, dev)
    t_ens = time.perf_counter() - t0
    check_launches("noise_map", fns, NOISE_MAP_KERNELS, records)
    body = body_pixels(ph, n, fov).to(dev)
    ratio = float(torch.median(var[1][body].double() / emp[body]))
    curve = [float(torch.median(v[body])) for v in vmi]
    i_min = int(np.argmin(curve))
    n_fall = VMI_KEV.index(VMI_MONOTONE_KEV) + 1
    falls = all(a > b for a, b in zip(curve[:n_fall - 1], curve[1:n_fall]))
    e_min = VMI_KEV[i_min]
    finite = all(bool(torch.isfinite(x).all()) and float(x[body].min()) > 0
                 for x in (*var, maps[0], maps[1], *vmi))
    print(f"  80 kV predicted / empirical variance over {int(body.sum())} "
          f"body pixels ({NOISE_REALISATIONS} Poisson draws through K4, "
          f"{t_ens:.2f} s): median {ratio:.4f} [within 0.10 of 1]")
    print("  VMI noise (median HU^2 over the body): " + ", ".join(
        f"{e:g} keV {c:.4g}" for e, c in zip(VMI_KEV, curve))
          + f"; falls over 40-{VMI_MONOTONE_KEV} keV: {falls}; minimum at "
          f"{e_min:g} keV [strictly inside, within {VMI_MIN_TOL_KEV:g} of "
          f"{VMI_MIN_KEV:g}]")
    print(f"  basis maps: median var1 {float(maps[0][body].median()):.4g}, "
          f"var2 {float(maps[1][body].median()):.4g}, cov12 "
          f"{float(maps[2][body].median()):.4g} (g/cm^3)^2; finite and "
          f"positive: {finite}")
    if not (abs(ratio - 1.0) < 0.10 and 0 < i_min < len(VMI_KEV) - 1
            and abs(e_min - VMI_MIN_KEV) <= VMI_MIN_TOL_KEV and falls
            and finite):
        fail("the noise-map path misses its checks")


def scatter_path(cfg, cone_cfgs, spectra, records, smi, dev):
    """Phase 4, protocol scatter prediction through the library, twice with
    the launch counters checked: the reference protocol's exact paths
    (K1) and counts (K2), ``single_scatter_sinogram`` of both acquisitions
    (K26, every 50th view), ``add_scatter`` then ``correct_scatter`` on the
    80 kV counts (spr 0.3, sigma 30 channels), and the cone config's 80 kV
    scan: K10 paths and K2 counts of every 45th view and
    ``single_scatter_conebeam`` (K27).  Checks: every scatter value finite
    and >= 0; the in-object SPR (``scatter_to_primary_ratio``, single
    scatter, no grid) of each scene within SPR_FACTOR of its SPR_REF, the
    cone's (4 cm collimation) above the fan's (1 cm); the corrected primary within 2 % of the true one on
    average (tests/test_scatter.py:85-99)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, spectral
    from dexct_tpu_torch.ops import scatter as sc_ops
    from dexct_tpu_torch.ops import scatter_physics as sp
    from dexct_tpu_torch.ops.siddon import material_path_sinogram

    ct, ph = cfg.ct, cfg.phantom
    ccfg = cone_cfgs["cone"]
    views = ct.betas[::FAN_SCATTER_EVERY]
    v3 = np.arange(ccfg.ct.N_proj)[::CONE_SCATTER_EVERY]
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        paths = material_path_sinogram(ph, ct, device=dev)
        counts = [spectral.forward_counts(paths, ph, s, ct)[0]
                  for s in spectra(ct)]
        st.mark("K1 trace + counts")
        fan = [sp.single_scatter_sinogram(ph, ct, s, views=views,
                                          device=dev, **FAN_SCATTER)
               for s in spectra(ct)]
        st.mark("single_scatter_sinogram x2")
        air = float(np.sum(spectral.effective_fluence(spectra(ct)[1], ct)))
        kern = sc_ops.scatter_kernel(ct.N_channels, sigma_ch=30.0)
        meas = sc_ops.add_scatter(counts[1], air, kern, spr=0.3)
        fixed = sc_ops.correct_scatter(meas, air, kern, spr=0.3)
        st.mark("add_scatter + correct_scatter")
        spec3 = spectra(ccfg.ct)[1]
        src, dirs = (torch.as_tensor(x[v3], dtype=torch.float32,
                                     device=dev).contiguous()
                     for x in ccfg.ct.ray_geometry_3d())
        paths3 = conebeam.trace_paths_3d(
            conebeam.labels_u8(ccfg.phantom.labels, dev), src, dirs,
            ccfg.phantom.dx, ccfg.phantom.dy, ccfg.phantom.dz,
            n_materials=ccfg.phantom.n_materials)
        counts3, _ = spectral.forward_counts(paths3, ccfg.phantom, spec3,
                                             ccfg.ct)
        st.mark("cone K10 trace + counts")
        cone = sp.single_scatter_conebeam(
            ccfg.phantom, ccfg.ct, spec3, views=ccfg.ct.betas[v3],
            device=dev, **CONE_SCATTER)
        st.mark("single_scatter_conebeam")
        print(f"scatter path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("scatter", fns, SCATTER_KERNELS, records)
    sub = slice(None, None, FAN_SCATTER_EVERY)
    spr = [sp.scatter_to_primary_ratio(s, c[sub].cpu().numpy())
           for s, c in zip(fan, counts)]
    spr3 = sp.scatter_to_primary_ratio(cone, counts3.cpu().numpy())
    ok_vals = all(np.isfinite(s).all() and s.min() >= 0
                  for s in (*fan, cone))
    frac = sc_ops.scatter_fraction(meas, counts[1], grid_p=0.95)
    rel = float(torch.mean(torch.abs(fixed - counts[1]) / counts[1]))
    got = dict(zip(SPR_REF, (*spr, spr3)))
    in_band = all(SPR_REF[k] / SPR_FACTOR < v < SPR_REF[k] * SPR_FACTOR
                  for k, v in got.items())
    print("  in-object SPR (single scatter, no grid): " + ", ".join(
        f"{k} {v:.5g} [JAX {SPR_REF[k]:g} x/ {SPR_FACTOR:g}]"
        for k, v in got.items())
          + f"; cone > fan; finite and >= 0: {ok_vals}")
    print(f"  kernel model: scatter fraction {frac:.4f}; correct_scatter "
          f"mean |P - P_true| / P_true {rel:.5f} [< 0.02]")
    if not (ok_vals and in_band and spr3 > spr[1] and rel < 0.02 and frac > 0.01):
        fail("the scatter path misses its checks")


def planning_devices_phase():
    """Phase 5: tiny noise maps (K1, K2, K3, K25 with one and three
    fields) and tiny fan (with and without Rayleigh) and cone scatter
    (K26, K27) on the CPU and on the card, from
    ``dexct_tpu_torch.utils.tiny_cases`` (the card tests run the same
    cases), each within 1e-4 of its maximum."""
    import numpy as np

    from dexct_tpu_torch.utils import tiny_cases as tc

    c, g = tc.noise_maps("cpu"), tc.noise_maps("cuda")
    for i, name in enumerate(("fbp variance", "var1", "var2", "cov12")):
        err = float((g[i] - c[i]).abs().max())
        big = float(c[i].abs().max())
        print(f"  noise map {name}: card vs CPU max abs {err:.3g} (max "
              f"{big:.4g}) [<= {tc.NOISE_TOL:g} x max]")
        if not err <= tc.NOISE_TOL * big:
            fail(f"tiny noise map {name} differs between the CPU and the "
                 "card")
    for kind in tc.SCATTER_KINDS:
        c, g = tc.scatter(kind, "cpu"), tc.scatter(kind, "cuda")
        err = float(np.abs(g - c).max())
        print(f"  scatter {kind}: card vs CPU max abs {err:.3g} (max "
              f"{c.max():.4g}) [<= {tc.SCATTER_TOL:g} x max]")
        if not err <= tc.SCATTER_TOL * c.max():
            fail(f"tiny scatter {kind} differs between the CPU and the card")


def realism_devices_phase():
    """Phase 5: the tiny realism paths of ``dexct_tpu_torch.utils.
    tiny_cases`` (a bowtie under MTF, gains and afterglow; tube-current
    modulation; the anode heel on a cone) on the CPU and on the card, each
    log and basis sinogram within REALISM_TOL of its maximum (the card
    tests run the same cases)."""
    from dexct_tpu_torch.utils import tiny_cases as tc

    for kind in tc.REALISM_KINDS:
        c, g = tc.realism(kind, "cpu"), tc.realism(kind, "cuda")
        errs = [float((gi - ci).abs().max() / ci.abs().max())
                for gi, ci in zip(g, c)]
        print(f"  realism {kind}: card vs CPU max abs / max per output "
              + ", ".join(f"{e:.3g}" for e in errs)
              + f" [<= {tc.REALISM_TOL:g}]")
        if not max(errs) <= tc.REALISM_TOL:
            fail(f"tiny realism path {kind} differs between the CPU and "
                 "the card")


def iterative_2d_path(cfg, records, smi, dev):
    """Phase 4, 2-D iterative reconstruction through the library on the
    reference protocol: the 60 keV sinogram of the exact paths (K1),
    Poisson counts at ITER_N0 per ray from a seeded generator, the Fourier
    plan, ``cg_recon`` (30 iterations, lam 0.05) and ``sirt_recon`` (50)
    on the noiseless sinogram, the FBP of the noisy one (K4) as PWLS's warm
    start and ``pwls_recon`` (60, beta 3e-2), twice, with the launch
    counters checked.  In the bladder (water) CG must read its 60 keV mu
    within 3 % (the JAX package's test_recovers_cylinder bar) and PWLS
    within 5 % with a standard deviation below 0.6 x the FBP's; SIRT
    nonnegative and finite."""
    import torch

    from dexct_tpu_torch.ops import fourier, iterative
    from dexct_tpu_torch.ops.fbp import fbp_recon
    from dexct_tpu_torch.ops.siddon import (material_path_sinogram,
                                            mono_sinogram)

    ct, ph = cfg.ct, cfg.phantom
    vs = (ct.N_proj, ct.N_channels)
    n, fov = ph.Nx, ph.Nx * ph.dx
    mu = mono_mu(ph, dev)
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        sino = mono_sinogram(material_path_sinogram(ph, ct, device=dev), mu)
        st.mark("trace (K1) + 60 keV sinogram")
        gen = torch.Generator(device=dev).manual_seed(5)
        counts = torch.clamp_min(torch.poisson(
            ITER_N0 * torch.exp(-sino), generator=gen), 1.0)
        y = -torch.log(counts / ITER_N0)
        st.mark("Poisson counts")
        plan = fourier.plan_fourier_projector(ph, ct, device=dev)
        st.mark("Fourier plan (host)")
        cg, hist = iterative.cg_recon(plan, sino, vs, n_iters=30, lam=0.05)
        st.mark("cg_recon (30 iterations)")
        sirt = iterative.sirt_recon(plan, sino, vs, n_iters=50)
        st.mark("sirt_recon (50 iterations)")
        fbp = fbp_recon(y, ct, n, fov, cfg.ramp)[0]
        st.mark("FBP warm start (K4)")
        pwls = iterative.pwls_recon(plan, y, counts, vs, n_iters=60,
                                    beta=3e-2, x0=torch.clamp_min(fbp, 0.0))
        st.mark("pwls_recon (60 iterations)")
        print(f"iterative_2d path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("iterative_2d", fns, ITERATIVE_2D_KERNELS, records)
    mu_w = float(mu[5])  # label 5: water (the bladder)
    roi = [roi_box(v[None], *BLADDER_XY, 0, fov, 1.0)
           for v in (cg, sirt, pwls, fbp)]
    means = [float(r.mean()) for r in roi]
    bias = [abs(m - mu_w) / mu_w for m in means]
    ratio = float(roi[2].std()) / float(roi[3].std())
    h = hist.cpu()
    finite = all(bool(torch.isfinite(v).all()) for v in (cg, sirt, pwls))
    print(f"  bladder ROI (mu_w {mu_w:.5f}): CG {means[0]:.5f} (off "
          f"{bias[0]:.4f}), SIRT {means[1]:.5f} (off {bias[1]:.4f}), PWLS "
          f"{means[2]:.5f} (off {bias[2]:.4f}), FBP {means[3]:.5f}; PWLS std "
          f"{float(roi[2].std()):.5f} = {ratio:.3f} x FBP's "
          f"{float(roi[3].std()):.5f}; CG residual {float(h[0]):.6g} -> "
          f"{float(h[-1]):.6g}; SIRT min {float(sirt.min()):.3g}; finite: "
          f"{finite}")
    if not (bias[0] < 0.03 and bias[2] < 0.05 and ratio < 0.6
            and float(h[-1]) < float(h[0]) and float(sirt.min()) >= 0.0
            and finite):
        fail("the 2-D iterative path misses its physics checks")
    adjoint_loops(plan, sino, y, counts, vs, torch.clamp_min(fbp, 0.0))


def adjoint_loops(plan, sino, y, counts, vs, x0):
    """The CG (30 iterations) and PWLS (60) loops of the iterative_2d path
    with the explicit A^T, as ``cg_recon`` and ``pwls_recon`` run them, and
    with autograd's (a forward pass and its backward per A^T), timed on the
    host clock in turns (explicit, autograd, autograd, explicit) after the
    path's runs.  One A^T of each is held to the other in phase 3; here the
    images' spread between the two is printed beside the explicit loops'
    own from run to run (the adjoints' atomics add in no fixed order and
    30 float32 CG iterations amplify it)."""
    import time

    import torch

    from dexct_tpu_torch.ops import iterative

    A = iterative.make_projection_operator(plan, vs)
    w = iterative.pwls_weights(counts)
    zero = torch.zeros_like(x0)

    def loops(adjoint):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cg = iterative._cg(A, sino, zero, 30, 0.05, adjoint=adjoint)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pw = iterative._pwls_fista(A, y, w, x0, 60, 3e-2, 5e-3, True, 12,
                                   adjoint=adjoint)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (cg, pw), ((t1 - t0) * 1e3, (t2 - t1) * 1e3)

    kinds = {"explicit": iterative._projection_adjoint(plan, vs),
             "autograd": autograd_adjoint(A, plan.n_img)}
    times = {k: [] for k in kinds}
    imgs = {k: [] for k in kinds}
    for k in ("explicit", "autograd", "autograd", "explicit"):
        out, t = loops(kinds[k])
        imgs[k].append(out)
        times[k].append(t)
    for k, ts in times.items():
        print(f"  loops with {k} A^T: CG (30) "
              + " / ".join(f"{t[0]:.1f}" for t in ts) + " ms, PWLS (60) "
              + " / ".join(f"{t[1]:.1f}" for t in ts) + " ms")
    (e1, e2), a1 = imgs["explicit"], imgs["autograd"][0]
    for i, name in enumerate(("CG", "PWLS")):
        print(f"  {name} images: autograd's A^T vs explicit max abs "
              f"{max_err(a1[i], e1[i])[0]:.3g}, explicit run to run "
              f"{max_err(e2[i], e1[i])[0]:.3g} (max "
              f"{float(e1[i].abs().max()):.6g})")


def onestep_path(cfg, spectra, records, smi, dev):
    """Phase 4, spectral MBIR through the library: the default path's
    two-step result on the reference protocol (both acquisitions' counts;
    the tissue and bone images on the 512^2 grid over 50 cm, clipped at 0)
    is the start, then a Fourier plan of that grid and
    ``onestep_spectral_recon`` at its default 300 Adam iterations on the
    union-grid tables of the decomposition, twice, with the launch counters
    checked.  The normalized data loss must fall below the start's, the
    images stay finite and nonnegative, and the bladder's tissue density
    read the two-step's within 5 %."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import fourier, onestep
    from dexct_tpu_torch.ops.matdecomp import (DEFAULT_BASIS,
                                               prepare_decomposition)
    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect

    ct = cfg.ct
    s1, s2 = spectra(ct)
    arrays, meta = pack_dect(ct, cfg.phantom, s1, s2, cfg.N_matrix, cfg.FOV,
                             cfg.ramp, device=dev, n_iters=50)
    out = dect_step(arrays, meta)
    counts = torch.stack(out["sino_raw"])
    x0 = torch.clamp_min(torch.stack(out["mat_recons"]), 0.0)
    del arrays, out
    ee, i0s, _ = prepare_decomposition(ct, s1, s2)
    n, grid = cfg.N_matrix, recon_grid(cfg)
    vs = (ct.N_proj, ct.N_channels)
    fns = zero_counters()
    for run in (1, 2):
        st = Stages()
        plan = fourier.plan_fourier_projector(grid, ct, device=dev)
        st.mark(f"Fourier plan of the {n}^2 grid (host)")
        x = onestep.onestep_spectral_recon(counts, ee, i0s, DEFAULT_BASIS,
                                           plan, vs, x0=x0)
        st.mark("onestep_spectral_recon (300 Adam iterations)")
        print(f"onestep path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
    check_launches("onestep", fns, ONESTEP_KERNELS, records)
    mus = torch.as_tensor(np.stack([b.mass_atten(ee)
                                    for b in DEFAULT_BASIS]),
                          dtype=torch.float32, device=dev)
    data = onestep._objective(
        lambda im, m, i: onestep.spectral_forward_images(plan, im, m, i, vs),
        counts, mus, torch.as_tensor(i0s, dtype=torch.float32, device=dev),
        0.0, 1e-2)
    with torch.no_grad():
        loss0, loss = float(data(x0)), float(data(x))
    tis = [float(roi_box(v[None], *BLADDER_XY, 0, cfg.FOV, 1.5).mean())
           for v in (x[0], x0[0])]
    off = abs(tis[0] - tis[1]) / tis[1]
    ok = bool(torch.isfinite(x).all()) and float(x.min()) >= 0.0
    print(f"  {x.shape[0]} x {n}^2 basis images; normalized data loss "
          f"{loss0:.6g} (two-step start) -> {loss:.6g}; bladder tissue "
          f"density {tis[0]:.5f} g/cm^3 vs the two-step's {tis[1]:.5f} (off "
          f"{off:.4f}); finite and nonnegative: {ok}")
    if not (loss < loss0 and off < 0.05 and ok):
        fail("the one-step path misses its checks")


def dose_path(cfg, cone_cfgs, spectra, records, smi, dev):
    """Phase 4, protocol dose studies through the library: ``dose_map`` of
    both acquisitions of input/params.txt (detunedMV 9 mGy, 80 kV 1 mGy;
    1000 views) with ``beam_energy_removed`` (K1), and ``dose_map_3d`` of
    the cone and helical configs at 80 kV with ``beam_energy_removed_3d``
    (K10), twice, with the launch counters checked.  Each deposited energy
    must lie within 5 % of the removed energy (the JAX package's
    conservation test); the organ report of the 2-D maps and the 3-D maps'
    z profiles are printed."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import dose

    jobs = [("params 2-D " + s.name, cfg.phantom, cfg.ct, s, False)
            for s in spectra(cfg.ct)]
    jobs += [(f"{label} 80kV", cone_cfgs[label].phantom, cone_cfgs[label].ct,
              spectra(cone_cfgs[label].ct)[1], True)
             for label in ("cone", "helical")]
    fns = zero_counters()
    for run in (1, 2):
        st, results, peaks = Stages(), [], {}
        for label, ph, ct, spec, three_d in jobs:
            fn = dose.dose_map_3d if three_d else dose.dose_map
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = fn(ph, ct, spec, device=dev)
            st.mark(f"{label} map")
            peaks[label] = torch.cuda.max_memory_allocated() / 1e9
            removed = (dose.beam_energy_removed_3d if three_d
                       else dose.beam_energy_removed)(ph, ct, spec,
                                                      device=dev)
            st.mark(f"{label} removed energy")
            results.append((label, res, removed))
        print(f"dose path (library, run {run}): "
              f"{sum(st.t.values()) / 1e3:.3f} s on {smi}; stages (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in st.t.items()))
        print("  peak device memory per map (GB): "
              + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()))
    check_launches("dose", fns, DOSE_KERNELS, records)
    ok = True
    for (label, ph, _, _, three_d), (_, res, removed) in zip(jobs, results):
        rel = abs(res.deposited_J - removed) / removed
        d = res.dose_mGy
        ok &= bool(np.isfinite(d).all()) and rel < 0.05
        print(f"  {label}: deposited {res.deposited_J:.6g} J, removed "
              f"{removed:.6g} J (rel {rel:.4f}); max {d.max():.6g} mGy")
        if three_d:
            prof = dose.dose_z_profile(d, ph.dx)
            print(f"    central 1 cm ROI dose per slice: {prof.min():.6g} .. "
                  f"{prof.max():.6g} mGy over {len(prof)} slices")
        else:
            rep = dose.organ_dose_report(d, ph)
            print("    organ dose (mean / max mGy): " + ", ".join(
                f"{k} {v['mean']:.4g}/{v['max']:.4g}" for k, v in rep.items()))
    if not ok:
        fail("a dose map misses the conservation check")


def new_paths_devices_phase():
    """Phase 5: tiny versions of the 2-D iterative, one-step and dose paths
    on the CPU and on the card, from ``dexct_tpu_torch.utils.tiny_cases``
    (the card tests run the same cases): CG, SIRT, PWLS and the one-step
    fit on a 48^2 Fourier plan with 64 x 48 rays fed one start vector (1e-3
    x max: the adjoints' atomics add in no fixed order), one gradient of the
    one-step objective (1e-4 x max), the 2-D and 3-D dose maps of a 32^2
    three-material phantom (1e-4 x max, deposited rel 1e-4)."""
    import numpy as np

    from dexct_tpu_torch.utils import tiny_cases as tc

    cases = [(p, lambda d, p=p: tc.iterative_2d(p, d), tc.ITERATIVE_TOL)
             for p in tc.ITERATIVE_PATHS]
    cases.append(("onestep gradient", tc.onestep_gradient, tc.GRADIENT_TOL))
    for label, fn, tol in cases:
        c, g = fn("cpu"), fn("cuda")
        err = float((g - c).abs().max())
        print(f"  {label}: card vs CPU max abs {err:.3g} (max "
              f"{float(c.abs().max()):.4g}) [<= {tol:g} x max]")
        if not err <= tol * float(c.abs().max()):
            fail(f"tiny {label} differs between the CPU and the card")
    for kind in tc.DOSE_KINDS:
        c, g = tc.dose(kind, "cpu"), tc.dose(kind, "cuda")
        err = float(np.abs(g.dose_mGy - c.dose_mGy).max())
        rel = abs(g.deposited_J - c.deposited_J) / c.deposited_J
        print(f"  dose {kind}: card vs CPU max abs {err:.3g} mGy (max "
              f"{c.dose_mGy.max():.4g}), deposited rel {rel:.3g}")
        if not (err <= tc.DOSE_TOL * c.dose_mGy.max()
                and rel <= tc.DOSE_TOL):
            fail(f"tiny dose {kind} differs between the CPU and the card")


def library_devices_phase():
    """Phase 5: tiny versions of the three library paths on the CPU and on
    the card: the helical 'pair' weighting through the fused cone step
    (pipeline tolerances), cone PWLS and CG fed one start vector (1e-3 x
    max: the adjoint's atomics add in no fixed order), the PI method (1e-4
    x max)."""
    import dataclasses

    import numpy as np
    import torch

    from dexct_tpu_torch.ops import conebeam, helical_pi
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.pipeline.cone import cone_dect_step, pack_cone_dect
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        HelicalConeBeamGeometry,
                                        water_cylinder_phantom)

    helix = HelicalConeBeamGeometry(N_channels=64, N_proj=96, N_rows=8,
                                    h_iso=0.5, eid=True, pitch=3.0)
    ph2 = water_cylinder_phantom(N=48, dx=0.5)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (16, 48, 48)).copy(),
        dz=0.5)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(helix.A_iso * 9.0 / helix.N_proj)
    s2.rescale_counts(helix.A_iso * 1.0 / helix.N_proj)
    cpu, gpu = (cone_dect_step(*pack_cone_dect(
        helix, ph3, s1, s2, 48, 20.0, 0.8, device=d, n_iters=8,
        weighting="pair")) for d in ("cpu", "cuda"))
    close_outputs(gpu, cpu, "tiny helical weighting pair")
    print("  helical weighting pair: every output agrees between the CPU "
          "and the card")
    rng = np.random.default_rng(26)
    ct = ConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4, h_iso=0.5)
    sino = rng.uniform(0.5, 2.0, (48, 4, 32)).astype(np.float32)
    counts = np.maximum(1500.0 * np.exp(-sino), 1.0)
    v0 = rng.normal(size=(4, 24, 24)).astype(np.float32)
    pw = [conebeam.cone_pwls_recon(sino, counts, ct, (4, 24, 24),
                                   (1.0, 1.0, 1.0), n_iters=20, beta=3e-2,
                                   device=d, _v0=v0).cpu()
          for d in ("cpu", "cuda")]
    cg = [conebeam.cone_cg_recon(sino, ct, (4, 24, 24), (1.0, 1.0, 1.0),
                                 n_iters=6, device=d)[0].cpu()
          for d in ("cpu", "cuda")]
    hsino = rng.uniform(0.5, 1.5, (96, 8, 64)).astype(np.float32)
    pi = [helical_pi.helical_pi_reconstruct(
        torch.as_tensor(hsino, device=d), helix, 48, 20.0, 0.8).cpu()
        for d in ("cpu", "cuda")]
    for label, (c, g), tol in (("cone PWLS", pw, 1e-3), ("cone CG", cg, 1e-3),
                               ("helical PI", pi, 1e-4)):
        err = float((g - c).abs().max())
        print(f"  {label}: card vs CPU max abs {err:.3g} (max "
              f"{float(c.abs().max()):.4g})")
        if not err <= tol * float(c.abs().max()):
            fail(f"tiny {label} differs between the CPU and the card")


FILE_TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
            "sino_log": dict(rtol=0.0, atol=1e-4),
            "recon_raw": dict(rtol=0.0, atol=1e-4),
            "recon_HU": dict(rtol=0.0, atol=1.0),
            "mat1_sino": dict(rtol=0.0, atol=1e-3),
            "mat2_sino": dict(rtol=0.0, atol=1e-3),
            "mat1_recon": dict(rtol=0.0, atol=1e-3),
            "mat2_recon": dict(rtol=0.0, atol=1e-3)}


def file_tol(name):
    """The tolerance of one output file: FILE_TOL; the denoised and BHC
    images those of recon_raw and recon_HU."""
    if name in FILE_TOL:
        return FILE_TOL[name]
    return FILE_TOL["recon_HU" if name.endswith("_HU") else "recon_raw"]


def compare_devices(tmp, label, params, flags, n_files=12):
    """Run ``params`` through the port's CLI on the CPU and on the card;
    every output file must agree to the pipeline tolerances."""
    import numpy as np

    from dexct_tpu_torch.run import main as run_main

    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = tmp / f"tiny_{label}_{dev}"
        run_main(["--params", str(params), "--output", str(outs[dev]),
                  "--spectrum-dir", str(SPECTRA), "--iters", "8",
                  "--device", dev] + flags)
    files = sorted(p.relative_to(outs["cpu"])
                   for p in outs["cpu"].rglob("*.bin"))
    if files != sorted(p.relative_to(outs["cuda"])
                       for p in outs["cuda"].rglob("*.bin")):
        fail("cpu and cuda runs wrote different file sets")
    if len(files) != n_files:
        fail(f"expected {n_files} output files, got {len(files)}")
    for rel in files:
        x = np.fromfile(outs["cpu"] / rel, np.float32)
        y = np.fromfile(outs["cuda"] / rel, np.float32)
        kind = rel.name[:-len("_float32.bin")]
        np.testing.assert_allclose(y, x, err_msg=str(rel), **file_tol(kind))
    print(f"  {label} path: {len(files)} files agree between --device cpu "
          "and --device cuda")


def both_devices_phase(tmp, label, flags, changes=None):
    """Phase 5: a 64^2 water-cylinder config (with one 2-D configuration's
    ``changes``) under one 2-D path's flags."""
    from dexct_tpu_torch.system.phantom import water_cylinder_phantom

    ph = water_cylinder_phantom(N=64, dx=0.4)
    ph.to_file(str(tmp / "ph.bin"), str(tmp / "ph.csv"))
    cfg = json.loads(PARAMS.read_text())
    cfg.update({"RUN_ID": "tiny", "phantom_id": "water_cyl",
                "phantom_filename": str(tmp / "ph.bin"),
                "matcomp_filename": str(tmp / "ph.csv"),
                "Nx": 64, "Ny": 64, "dx": 0.4, "dy": 0.4, "dz": 0.4,
                "N_channels": 64, "N_projections": 64,
                "detector_filename": str(ROOT / cfg["detector_filename"]),
                "N_recon_matrix": 64, "FOV_recon": 26.0, **(changes or {})})
    (tmp / "tiny.txt").write_text(json.dumps(cfg))
    extra = 8 * ("--bhc" in flags) + 4 * ("--denoise" in flags)
    compare_devices(tmp, label, tmp / "tiny.txt", flags, 12 + extra)


def zstack_devices_phase():
    """Phase 5: a 3-slice 64^2 z-stack through the library on the CPU and
    on the card, both projectors' paths (K17, and the Fourier projector's
    slice batch); every output agrees to the pipeline tolerances."""
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.pipeline.zstack import (pack_zstack, stack_phantom,
                                                 zstack_step)
    from dexct_tpu_torch.system import (FanBeamGeometry,
                                        contrast_rods_phantom)

    ct = FanBeamGeometry(N_channels=64, N_proj=96, eid=True)
    ph = stack_phantom(contrast_rods_phantom, 3, N=64, dx=0.4)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    for projector, recon in (("siddon", "parallel"), ("fourier", "fan")):
        cpu, gpu = (zstack_step(*pack_zstack(
            ct, ph, s1, s2, 64, 20.0, 0.8, device=d, n_iters=8,
            projector=projector, recon=recon, n_theta=128, recon_n_theta=64,
            recon_nt=128)) for d in ("cpu", "cuda"))
        close_outputs(gpu, cpu, f"tiny zstack ({projector}, {recon})")
        print(f"  zstack ({projector}, {recon}): every output of the 3 "
              "slices agrees between the CPU and the card")


def cone_devices_phase(tmp, label, spec, flags):
    """Phase 5: a 32^2 x 8 water cylinder under a 24-view (48 over two
    turns for the helix) 4-row version of one 3-D path's configuration."""
    import numpy as np

    from dexct_tpu_torch.system.phantom import (VoxelPhantom,
                                                water_cylinder_phantom)

    ph = water_cylinder_phantom(N=32, dx=0.6)
    lab = np.broadcast_to(ph.labels[0], (8, 32, 32)).copy()
    VoxelPhantom("w3", lab, ph.materials, 0.6, 0.6, 0.5).to_file(
        str(tmp / "w3.bin"), str(tmp / "w3.csv"))
    cfg = json.loads(PARAMS.read_text())
    cfg.update({"RUN_ID": "tiny3d", "phantom_id": "water3d",
                "phantom_filename": str(tmp / "w3.bin"),
                "matcomp_filename": str(tmp / "w3.csv"),
                "Nx": 32, "Ny": 32, "Nz": 8, "dx": 0.6, "dy": 0.6,
                "dz": 0.5, "N_rows": 4, "detector_px_height": 0.5,
                "N_channels": 32, "N_projections": 24,
                "detector_filename": str(ROOT / cfg["detector_filename"]),
                "N_recon_matrix": 32, "FOV_recon": 18.0,
                **{k: spec[k] for k in VARIANT_KEYS if k in spec}})
    if cfg["scanner_geometry"] == "helical_cone_beam":
        cfg.update({"N_projections": 48, "pitch": 2.0,
                    "rotation_angle_total": 4 * np.pi})
    (tmp / f"{label}.txt").write_text(json.dumps(cfg))
    compare_devices(tmp, label, tmp / f"{label}.txt", flags)


def main():
    parser = argparse.ArgumentParser(
        description="Chip smoke test of the PyTorch port on one GPU.")
    parser.add_argument(
        "--witness", type=lambda p: Path(p).resolve(), default=None,
        help="also write the helical config's log sinograms and the "
             "weighted library paths' central slices to this directory, for "
             "the witness in tests/test_torch_cone.py")
    args = parser.parse_args()
    t_start = time.time()
    # line by line, also into a pipe: a run cut short keeps what it printed
    sys.stdout.reconfigure(line_buffering=True)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "dexct_tpu_torch").is_dir() or not PARAMS.exists():
        fail(f"run from a checkout of the repository ({ROOT} lacks "
             "dexct_tpu_torch/ or input/params.txt)")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)  # params.txt names its inputs relative to the repo root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    # 2. build
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.utils import kernels

    t0 = time.time()
    kernels.build()
    kernels.library()
    t1 = time.time()
    dev = torch.device("cuda")
    spectral.counts_from_paths(torch.zeros((1, 1), device=dev),
                               torch.zeros((1, 1), device=dev),
                               torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    t2 = time.time()
    print(f"build: nvcc K1, K3-K13, K15-K27, K29-K33, K35-K39 "
          f"{t1 - t0:.1f} s, triton K2 {t2 - t1:.1f} s")

    # 3. kernels against their plain versions at the paths' shapes
    from dexct_tpu_torch.pipeline.cone import pack_cone_dect
    from dexct_tpu_torch.pipeline.fused import pack_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.system.analytic import pelvis_analytic
    from dexct_tpu_torch.system.config import read_parameter_file

    tmp = Path(tempfile.mkdtemp(prefix="dexct_chip_smoke_"))
    try:
        cfg = read_parameter_file(PARAMS)[0]
        gens = default_generators()

        def spectra(ct):
            return (_resolve_spectrum("detunedMV", 9.0, ct, str(SPECTRA),
                                      gens),
                    _resolve_spectrum("80kV", 1.0, ct, str(SPECTRA), gens))

        pack = (cfg.ct, cfg.phantom, *spectra(cfg.ct), cfg.N_matrix, cfg.FOV,
                cfg.ramp)
        print(f"kernels vs plain ({smi}):")
        records = {}
        arrays, meta = pack_dect(*pack, device=dev, n_iters=50,
                                 projector="siddon", recon="fan")
        kernel_phase(arrays, meta, records)
        arrays, meta = pack_dect(*pack, device=dev, n_iters=50,
                                 projector="fourier", recon="parallel")
        default_kernel_phase(arrays, meta, records)
        arrays, meta = pack_dect(cfg.ct, pelvis_analytic(), *pack[2:],
                                 device=dev, n_iters=50,
                                 projector="analytic", recon="parallel")
        analytic_kernel_phase(arrays, meta, records)
        cone_params = {label: write_cone_params(tmp, label, spec)
                       for label, spec in CONE_CONFIGS.items()}
        cone_cfgs = {label: read_parameter_file(p)[0]
                     for label, p in cone_params.items()}
        for label in ("cone", "helical"):
            ccfg = cone_cfgs[label]
            arrays, meta = pack_cone_dect(
                ccfg.ct, ccfg.phantom, *spectra(ccfg.ct), ccfg.N_matrix,
                ccfg.FOV, ccfg.ramp, device=dev, n_iters=50)
            cone_kernel_phase(arrays, meta, records, label == "helical")
        del arrays
        torch.cuda.empty_cache()
        project_kernel_phase(cone_cfgs["cone"], records)
        torch.cuda.empty_cache()
        pi_kernel_phase(cone_cfgs["helical"], records, dev)
        torch.cuda.empty_cache()
        stateless_phases = (("flat", flat_kernel_phase),
                            ("tilted", tilted_kernel_phase),
                            ("zffs",
                             lambda c, st, _: zffs_kernel_phase(c, st)),
                            ("helical", katsevich_kernel_phase))
        for label, phase in stateless_phases:
            ccfg = cone_cfgs[label]
            phase(ccfg, stateless_stack(ccfg, spectra, dev), records)
            torch.cuda.empty_cache()
        config_files = dict(cone_params)
        config_files.update({label: write_2d_params(tmp, label, changes)
                             for label, changes in CONFIGS_2D.items()})
        work = zstack_workload()
        zstack_kernel_phase(work, records, dev)
        ffs_kernel_phase(read_parameter_file(config_files["ffs"])[0],
                         spectra, dev)
        torch.cuda.empty_cache()
        fourier_adjoint_kernel_phase(cfg, records, dev)
        torch.cuda.empty_cache()
        dose_kernel_phase(cfg, cone_cfgs, spectra, records, dev)
        torch.cuda.empty_cache()
        noise_kernel_phase(cfg, spectra, records, dev)
        torch.cuda.empty_cache()
        scatter_kernel_phase(cfg, cone_cfgs, spectra, records, dev)
        torch.cuda.empty_cache()
        realism_kernel_phase(cfg, cone_cfgs["cone"], spectra, records, dev)
        torch.cuda.empty_cache()
        motion_kernel_phase(cfg, cone_cfgs, spectra, records, dev)
        torch.cuda.empty_cache()
        pcd = pcd_setup(tmp, dev, gens)
        spectral_kernel_phase(cfg, pcd, spectra, records, dev)
        torch.cuda.empty_cache()
        afterglow_kernel_phase(cfg, cone_cfgs["cone"], spectra, records, dev)
        gather_kernel_phase(records, dev)

        # 4. the paths: the CLI's, then the library's
        from dexct_tpu_torch.run import main as run_main

        for name in KERNELS:
            records[name]["launches"] = 0
        bodies = {}
        for label, (flags, config, path_kernels) in PATHS.items():
            params = config_files[config] if config else PARAMS
            cone = config if config in CONE_CONFIGS else None
            fns = zero_counters()
            walls = []
            for i in (1, 2):
                res = run_main(["--params", str(params), "--output",
                                str(tmp / f"{label}{i}"), "--spectrum-dir",
                                str(SPECTRA)] + flags)
                torch.cuda.synchronize()
                walls.append(res[0].wall_s)
            print(f"{label} path {flags}: wall per DE pair {walls[0]:.3f} s "
                  f"(first), {walls[1]:.3f} s (steady) on {smi}")
            check_launches(label, fns, path_kernels, records)
            if cone:
                ccfg = cone_cfgs[cone]
                vol = res[0].dect.recon_raw[0]
                n_files, bodies[label] = check_outputs_3d(
                    tmp / f"{label}2", ccfg.run_id,
                    (ccfg.ct.N_proj, ccfg.ct.N_rows, ccfg.ct.N_channels),
                    vol.shape[0], ccfg.N_matrix, tilted=label == "tilted")
                print(f"  {n_files} output files: exact sizes, finite")
                if label in SAME_SLICE_AS_CONE:
                    d = [b - c for b, c in zip(bodies[label],
                                               bodies["cone"])]
                    print(f"  body ROI minus the cone path's: detunedMV "
                          f"{d[0]:.2f}, 80kV {d[1]:.2f} HU")
                    if max(abs(x) for x in d) > BODY_TOL_HU:
                        fail(f"the {label} path's body ROI is {d} HU off "
                             f"the cone path's")
                if label in STATELESS:
                    stateless_stage_profile(
                        ccfg, label, "katsevich" if label == "katsevich"
                        else "auto", tmp, smi)
                else:
                    cone_stage_profile(ccfg, label, tmp, smi)
            else:
                run_cfg = read_parameter_file(params)[0]
                n_files = check_outputs(tmp / f"{label}2", run_cfg.run_id,
                                        run_cfg.ct.N_proj,
                                        run_cfg.ct.N_channels,
                                        run_cfg.N_matrix,
                                        AIR_XY.get(label, (0.0, -20.0)))
                if label == "bhc_denoise":
                    n_files += check_extra_2d(tmp / f"{label}2", run_cfg)
                print(f"  {n_files} output files: exact sizes, finite")
                if config in CONFIGS_2D:
                    composed_stage_profile(run_cfg, label, tmp, smi)
                elif label == "bhc_denoise":
                    bhc_denoise_stage_profile(run_cfg, smi)
            shutil.rmtree(tmp / f"{label}1", ignore_errors=True)
            shutil.rmtree(tmp / f"{label}2", ignore_errors=True)
        analytic_path(records, smi)
        zstack_path(records, work, smi)
        del work
        torch.cuda.empty_cache()
        helical_weightings_path(cone_cfgs["helical"], spectra, records, smi,
                                args.witness)
        cone_pwls_path(cone_cfgs["cone"], records, smi)
        torch.cuda.empty_cache()
        helical_pi_path(cone_cfgs["helical"], records, smi)
        torch.cuda.empty_cache()
        iterative_2d_path(cfg, records, smi, dev)
        torch.cuda.empty_cache()
        onestep_path(cfg, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        dose_path(cfg, cone_cfgs, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        noise_map_path(cfg, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        scatter_path(cfg, cone_cfgs, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        realistic_path(cfg, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        tcm_path(cfg, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        heel_path(cone_cfgs["cone"], spectra, records, smi, dev)
        torch.cuda.empty_cache()
        motion_path(cfg, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        gated_path(cfg, records, smi, dev)
        torch.cuda.empty_cache()
        motion_3d_path(cone_cfgs, spectra, records, smi, dev)
        torch.cuda.empty_cache()
        spectral_path(cfg, pcd, records, smi, dev)
        torch.cuda.empty_cache()
        spectral_cone_path(tmp, cone_cfgs, records, smi, dev, gens)
        torch.cuda.empty_cache()
        acquisition_modes_path(cfg, spectra, records, smi, dev, gens)
        torch.cuda.empty_cache()
        gather_probe_path(records, smi)
        torch.cuda.empty_cache()
        sweep_path(records, smi, dev)
        torch.cuda.empty_cache()

        # 5. every path on both devices
        for label, (flags, config, _) in PATHS.items():
            if config in CONE_CONFIGS:
                cone_devices_phase(tmp, label, CONE_CONFIGS[config], flags)
            else:
                both_devices_phase(tmp, label, flags,
                                   CONFIGS_2D.get(config))
        zstack_devices_phase()
        library_devices_phase()
        new_paths_devices_phase()
        planning_devices_phase()
        realism_devices_phase()
        motion_devices_phase()
        spectral_devices_phase()
        sweep_devices_phase()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"chip_smoke wall time: {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{k: records[n][k] for k in order}
                                  for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
