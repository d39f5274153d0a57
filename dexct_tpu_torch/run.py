"""CLI: ``python -m dexct_tpu_torch.run --params ./input/params.txt``.

The PyTorch port of ``python -m dexct_tpu.run``: the same flags, the same
defaults and the same output tree, plus ``--device``.  The default path is
the JAX CLI's: the Fourier-slice projector with rebinned parallel-beam
reconstruction (``--projector fourier --recon parallel``); ``--projector
siddon --recon fan`` runs the exact trace with direct fan-beam
reconstruction.  Cone-beam and helical configs run the fused cone
pipeline (circular FDK or helical generalized Feldkamp, ``--recon3d``);
flat-panel and gantry-tilted configs, a z flying focal spot and
``--recon3d katsevich`` (exact helical reconstruction) run the stateless
3-D branch.  Parallel-beam configs and fan-beam configs with an in-plane
flying focal spot run the composed path (the 16-tap interleaved rebin for
the latter).  ``--bhc`` writes water- and bone-BHC reconstructions of 2-D
configs; ``--denoise`` writes the learned denoiser's images.  Float32
matrix products run in full float32 on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, set by ``main``), and
so do the denoiser's convolutions
(:func:`dexct_tpu_torch.learn.train.apply_denoiser`).
"""

from __future__ import annotations

import argparse


def parse_pairs(items):
    pairs = []
    for it in items:
        parts = it.split(",")
        if len(parts) != 4:
            raise SystemExit(
                f"error: --pair expects SPEC1,SPEC2,DOSE1,DOSE2 "
                f"(e.g. detunedMV,80kV,9,1); got {it!r}"
            )
        s1, s2, d1, d2 = parts
        try:
            pairs.append((s1, s2, float(d1), float(d2)))
        except ValueError:
            raise SystemExit(
                f"error: --pair doses must be numbers; got {it!r}"
            )
    return tuple(pairs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--params", default="./input/params.txt")
    p.add_argument("--output", default="./output")
    p.add_argument("--spectrum-dir", default="./input/spectrum")
    p.add_argument(
        "--pair", action="append", default=[],
        metavar="SPEC1,SPEC2,DOSE1,DOSE2",
        help="DE pair, e.g. detunedMV,80kV,9,1 (repeatable; default: "
        "the reference protocol)",
    )
    p.add_argument("--noise", choices=["none", "poisson", "gaussian"],
                   default="none")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator that draws the noise")
    p.add_argument("--iters", type=int, default=50,
                   help="Gauss-Newton iterations (reference uses 50)")
    p.add_argument("--engine", choices=["fused", "composed"],
                   default="fused")
    p.add_argument("--projector",
                   choices=["fourier", "siddon", "siddon_dominant"],
                   default="fourier",
                   help="fourier: Fourier-slice projector (square phantoms; "
                   "others run siddon); siddon: exact trace; "
                   "siddon_dominant runs the same exact per-ray kernel as "
                   "siddon")
    p.add_argument("--recon", choices=["parallel", "fan"],
                   default="parallel",
                   help="parallel: rebinned parallel-beam FBP (full "
                   "rotations; partial ones run fan); fan: direct fan-beam "
                   "FBP")
    p.add_argument("--recon3d",
                   choices=["auto", "fdk", "helical", "katsevich"],
                   default="auto",
                   help="3-D reconstruction for cone/helical configs: "
                   "auto picks fdk for a circular orbit and helical "
                   "(generalized Feldkamp) for a helical one; katsevich is "
                   "the exact helical reconstruction; fan-beam configs "
                   "ignore it")
    p.add_argument("--bhc", action="store_true",
                   help="also write water/bone BHC reconstructions (2-D "
                   "configs)")
    p.add_argument("--denoise", action="store_true",
                   help="also write learned-denoiser reconstructions "
                   "(recon_denoised_{raw,HU})")
    p.add_argument("--resume", action="store_true",
                   help="skip DE pairs whose stage artifacts exist")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch

    from .pipeline.runner import run_parameter_file

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda, but no CUDA device is "
                         "available (use --device cpu)")
    # full float32 products on the card: TF32 keeps ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    return run_parameter_file(
        args.params,
        out_dir=args.output,
        spec_pairs=parse_pairs(args.pair) if args.pair else None,
        spectrum_dir=args.spectrum_dir,
        noise=args.noise,
        seed=args.seed,
        n_iters=args.iters,
        engine=args.engine,
        projector=args.projector,
        recon=args.recon,
        recon3d=args.recon3d,
        bhc=args.bhc,
        resume=args.resume,
        denoise=args.denoise,
        device=args.device,
    )


if __name__ == "__main__":
    main()
