"""Pipeline: reference-compatible API, fused steps, the spectral PCD and
acquisition-mode pipelines, run driver."""

from .api import (
    DectResult,
    effective_water_mu,
    get_basismat_sinos,
    get_recon,
    get_sino,
    load_spectrum,
    simulate_dect,
)
from .cone import ConeDectMeta, cone_dect_step, pack_cone_dect
from .dualsource import simulate_dualsource_dect
from .gated import gate_weights, gated_fbp_recon, gated_series, view_phases
from .realism import (Stage, apply_chain, correct_chain,
                      simulate_dect_realistic)
from .kvswitch import simulate_kvswitch_dect
from .runner import DEFAULT_SPEC_PAIRS, run_config, run_parameter_file
from .spectralct import (SpectralResult, make_jitted_pcd_cone_step,
                         make_jitted_pcd_step, pack_pcd_spectral,
                         pack_pcd_spectral_cone, simulate_pcd_spectral,
                         simulate_pcd_spectral_cone)
from .sweep import (dose_sweep, ramp_sweep, sharded_dose_sweep,
                    slice_sweep, sweep_mesh)
from .tcm import auto_tcm_profile, simulate_tcm_dect
from .zstack import (make_jitted_zstack_step, pack_zstack, stack_phantom,
                     zstack_step)

__all__ = [
    "dose_sweep",
    "ramp_sweep",
    "slice_sweep",
    "sweep_mesh",
    "sharded_dose_sweep",
    "simulate_kvswitch_dect",
    "simulate_dualsource_dect",
    "gated_fbp_recon",
    "gated_series",
    "gate_weights",
    "view_phases",
    "Stage",
    "apply_chain",
    "correct_chain",
    "simulate_dect_realistic",
    "SpectralResult",
    "simulate_pcd_spectral",
    "simulate_pcd_spectral_cone",
    "pack_pcd_spectral",
    "pack_pcd_spectral_cone",
    "make_jitted_pcd_step",
    "make_jitted_pcd_cone_step",
    "auto_tcm_profile",
    "simulate_tcm_dect",
    "get_sino",
    "get_recon",
    "get_basismat_sinos",
    "load_spectrum",
    "simulate_dect",
    "effective_water_mu",
    "DectResult",
    "run_config",
    "run_parameter_file",
    "DEFAULT_SPEC_PAIRS",
    "ConeDectMeta",
    "pack_cone_dect",
    "cone_dect_step",
    "pack_zstack",
    "zstack_step",
    "make_jitted_zstack_step",
    "stack_phantom",
]
