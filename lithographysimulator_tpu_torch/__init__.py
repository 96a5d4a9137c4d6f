"""PyTorch/CUDA port of lithographysimulator_tpu.

Aerial imaging with the exact Abbe solvers (Gau'23 and direct) and the
SOCS (Hopkins) fast path, scalar or vector (Jones pupil), monochromatic or
polychromatic, through focus, thin or thick mask (boundary-layer and
edge-kernel M3D models, calibrated against the in-repo RCWA solver), in
the resist film (the rigorous film stack), with scanner perturbations;
then the resist (lumped, Mack, depth-resolved with the eikonal 3-D
develop, stochastic Monte-Carlo ensembles, calibration, CD metrology),
and the full chip (tiled imaging of masks larger than one field, the
focus-exposure matrix, ORC, MEEF maps, defect dispositions, mask rule
checks), optimization through the imaging gradient (source-mask
optimization, aberration retrieval, resist-aware, full-chip and
process-window OPC: :mod:`.optimize`), assist features and multiple
patterning, on a CUDA device through hand-written int8 limb kernels
(``csrc/intensity_int8.cu``, differentiable: the backward recomputes in
float32) or on the CPU through their plain PyTorch versions. Every entry
point takes an explicit ``device``. Layouts come in and contours go out
through :mod:`.io` (GDSII, OASIS, a C++ rasterizer on the host);
:mod:`.serve` is the HTTP worker (cross-request batching, full-chip jobs)
and router.

Importing the package turns TF32 off for float32 matmuls and cuDNN: TF32
keeps ~3 decimal digits, far below the fp32 accuracy class the engines
are held to.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (DEMO_CONFIG, LaserSpectrum, OpticsConfig,
                     WavelengthScaling, nearest_pow2)
from .grid import Grid, unit_disk_mask
from .metrology import (apply_dose_map, defect_printability,
                        dose_correction_map, orc_check, tiled_fem,
                        tiled_focus_images, tiled_meef, tiled_meef_map,
                        tiled_stochastic)
from .models.mask import (Mask, alternating_psm, attenuated_psm, contact_holes,
                          demo_bars, from_array, lines_and_spaces)
from .models.mrc import MaskRules, mrc_check, mrc_clean
from .models.multipatterning import (decompose_lele, decompose_multipatterning,
                                     lele_print, multipatterning_print)
from .models.calibrate import calibrate_resist, gauge_cd
from .models.pupil import Pupil, pupil_function
from .models.resist import (DepthResist, MackResist, ResistModel,
                            aligned_edge_positions, cd_uniformity,
                            critical_dimension, edge_placement_errors,
                            exposure_latitude, feature_table, hotspots, meef,
                            meef_table, nils_table, pattern_fidelity,
                            process_window, swing_curve)
from .models.source import LightSource
from .models.sraf import sraf_band, sraf_insert, sraf_print_check
from .models.stochastic import (StochasticResist, acf_correlation_length,
                                edge_psd, exposure_summary, exposure_trials,
                                fit_psd_model, stochastic_ensemble,
                                stochastic_psd, stochastic_volume_ensemble)
from .ops.abbe import (SourcePoints, abbe_image, abbe_image_points,
                       accumulate_intensity, source_points)
from .ops.compensated import matmul_compensated
from .ops.eikonal import arrival_times, godunov_update
from .ops.filmstack import (WaferStack, film_component_multipliers,
                            film_depth_factors, open_frame_profile,
                            substrate_reflectance, underlayer_sweep)
from .ops.focus import (chromatic_aberrations, focus_stack_aberrations,
                        through_focus_images)
from .ops.fraunhofer import mask_spectrum, spectrum_direct, spectrum_fft
from .ops.hopkins import (SOCSKernels, auto_rank_socs,
                          principal_channel_rotation, randomized_socs,
                          randomized_socs_chromatic,
                          randomized_socs_components, randomized_socs_vector,
                          socs_energy_captured, socs_image,
                          socs_image_nrms_bound, tcc_eigensystem,
                          tcc_total_trace)
from .ops.mask3d import (BoundaryLayer, EdgeKernelM3D, apply_boundary_layers,
                         apply_edge_kernel, boundary_layer_from_rcwa,
                         edge_fields_signed, fit_boundary_layer,
                         fit_edge_kernel, model_from_json, model_to_json)
from .ops.perturb import ImagePerturbation, apply_perturbation
from .ops.tiled import (array_window_fn, default_halo, tiled_film_stack,
                        tiled_socs_image, tiled_socs_image_field,
                        tiled_socs_image_scan, tiled_socs_image_stream)
from .ops.rcwa import (MASK_STACKS, GratingLayer, MaskStack,
                       rcwa_effective_mask, rcwa_orders, resolve_stack,
                       thin_mask_transmission)
from .ops.vector import polarization_states, vector_abbe_image, vector_pupils
from .ops.zernike import (fringe_index_to_mn, noll_index_to_mn,
                          osa_index_to_mn, to_osa_coefficients,
                          wavefront_error, zernike_basis)
from .simulate import (SimulationResult, film_socs_kernels, film_socs_stack,
                       film_stack_images, simulate, simulate_batch)

__version__ = "0.1.0"

__all__ = [
    "BoundaryLayer",
    "DEMO_CONFIG",
    "DepthResist",
    "EdgeKernelM3D",
    "GratingLayer",
    "Grid",
    "ImagePerturbation",
    "LaserSpectrum",
    "LightSource",
    "MASK_STACKS",
    "MackResist",
    "Mask",
    "MaskRules",
    "MaskStack",
    "OpticsConfig",
    "Pupil",
    "ResistModel",
    "SOCSKernels",
    "SimulationResult",
    "SourcePoints",
    "StochasticResist",
    "WaferStack",
    "WavelengthScaling",
    "abbe_image",
    "abbe_image_points",
    "accumulate_intensity",
    "acf_correlation_length",
    "aligned_edge_positions",
    "alternating_psm",
    "apply_boundary_layers",
    "apply_dose_map",
    "apply_edge_kernel",
    "apply_perturbation",
    "array_window_fn",
    "arrival_times",
    "attenuated_psm",
    "auto_rank_socs",
    "boundary_layer_from_rcwa",
    "calibrate_resist",
    "cd_uniformity",
    "chromatic_aberrations",
    "contact_holes",
    "critical_dimension",
    "decompose_lele",
    "decompose_multipatterning",
    "default_halo",
    "defect_printability",
    "demo_bars",
    "dose_correction_map",
    "edge_fields_signed",
    "edge_placement_errors",
    "edge_psd",
    "exposure_latitude",
    "exposure_summary",
    "exposure_trials",
    "feature_table",
    "film_component_multipliers",
    "film_depth_factors",
    "film_socs_kernels",
    "film_socs_stack",
    "film_stack_images",
    "fit_boundary_layer",
    "fit_edge_kernel",
    "fit_psd_model",
    "focus_stack_aberrations",
    "fringe_index_to_mn",
    "from_array",
    "gauge_cd",
    "godunov_update",
    "hotspots",
    "lele_print",
    "lines_and_spaces",
    "mask_spectrum",
    "matmul_compensated",
    "meef",
    "meef_table",
    "model_from_json",
    "model_to_json",
    "mrc_check",
    "mrc_clean",
    "multipatterning_print",
    "nearest_pow2",
    "nils_table",
    "noll_index_to_mn",
    "open_frame_profile",
    "orc_check",
    "osa_index_to_mn",
    "pattern_fidelity",
    "polarization_states",
    "principal_channel_rotation",
    "process_window",
    "pupil_function",
    "randomized_socs",
    "randomized_socs_chromatic",
    "randomized_socs_components",
    "randomized_socs_vector",
    "rcwa_effective_mask",
    "rcwa_orders",
    "resolve_stack",
    "simulate",
    "simulate_batch",
    "socs_energy_captured",
    "socs_image",
    "socs_image_nrms_bound",
    "source_points",
    "spectrum_direct",
    "spectrum_fft",
    "sraf_band",
    "sraf_insert",
    "sraf_print_check",
    "stochastic_ensemble",
    "stochastic_psd",
    "stochastic_volume_ensemble",
    "substrate_reflectance",
    "swing_curve",
    "tcc_eigensystem",
    "tcc_total_trace",
    "thin_mask_transmission",
    "through_focus_images",
    "tiled_fem",
    "tiled_film_stack",
    "tiled_focus_images",
    "tiled_meef",
    "tiled_meef_map",
    "tiled_socs_image",
    "tiled_socs_image_field",
    "tiled_socs_image_scan",
    "tiled_socs_image_stream",
    "tiled_stochastic",
    "to_osa_coefficients",
    "underlayer_sweep",
    "unit_disk_mask",
    "vector_abbe_image",
    "vector_pupils",
    "wavefront_error",
    "zernike_basis",
]
