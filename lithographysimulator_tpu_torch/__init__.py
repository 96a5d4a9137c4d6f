"""PyTorch/CUDA port of lithographysimulator_tpu.

Aerial imaging with the exact Abbe solvers (Gau'23 and direct) and the
SOCS (Hopkins) fast path, scalar or vector (Jones pupil), monochromatic or
polychromatic, through focus, thin or thick mask (boundary-layer and
edge-kernel M3D models, calibrated against the in-repo RCWA solver), in
the resist film (the rigorous film stack), with scanner perturbations, on
a CUDA device through hand-written int8 limb kernels
(``csrc/intensity_int8.cu``, differentiable: the backward recomputes in
float32) or on the CPU through their plain PyTorch versions. Every entry
point takes an explicit ``device``.

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
from .models.mask import (Mask, alternating_psm, attenuated_psm, contact_holes,
                          demo_bars, from_array, lines_and_spaces)
from .models.pupil import Pupil, pupil_function
from .models.source import LightSource
from .ops.abbe import (SourcePoints, abbe_image, abbe_image_points,
                       accumulate_intensity, source_points)
from .ops.compensated import matmul_compensated
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
    "EdgeKernelM3D",
    "GratingLayer",
    "Grid",
    "ImagePerturbation",
    "LaserSpectrum",
    "LightSource",
    "MASK_STACKS",
    "Mask",
    "MaskStack",
    "OpticsConfig",
    "Pupil",
    "SOCSKernels",
    "SimulationResult",
    "SourcePoints",
    "WaferStack",
    "WavelengthScaling",
    "abbe_image",
    "abbe_image_points",
    "accumulate_intensity",
    "alternating_psm",
    "apply_boundary_layers",
    "apply_edge_kernel",
    "apply_perturbation",
    "attenuated_psm",
    "auto_rank_socs",
    "boundary_layer_from_rcwa",
    "chromatic_aberrations",
    "contact_holes",
    "demo_bars",
    "edge_fields_signed",
    "film_component_multipliers",
    "film_depth_factors",
    "film_socs_kernels",
    "film_socs_stack",
    "film_stack_images",
    "fit_boundary_layer",
    "fit_edge_kernel",
    "focus_stack_aberrations",
    "fringe_index_to_mn",
    "from_array",
    "lines_and_spaces",
    "mask_spectrum",
    "matmul_compensated",
    "model_from_json",
    "model_to_json",
    "nearest_pow2",
    "noll_index_to_mn",
    "open_frame_profile",
    "osa_index_to_mn",
    "polarization_states",
    "principal_channel_rotation",
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
    "substrate_reflectance",
    "tcc_eigensystem",
    "tcc_total_trace",
    "thin_mask_transmission",
    "through_focus_images",
    "to_osa_coefficients",
    "underlayer_sweep",
    "unit_disk_mask",
    "vector_abbe_image",
    "vector_pupils",
    "wavefront_error",
    "zernike_basis",
]
