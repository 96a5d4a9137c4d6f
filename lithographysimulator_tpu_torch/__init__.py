"""PyTorch/CUDA port of lithographysimulator_tpu: thin-mask imaging.

Thin-mask aerial imaging with the exact Abbe solvers (Gau'23 and direct)
and the SOCS (Hopkins) fast path, scalar or vector (Jones pupil),
monochromatic or polychromatic, through focus, with scanner perturbations,
on a CUDA device through hand-written int8 limb kernels
(``csrc/intensity_int8.cu``) or on the CPU through their plain PyTorch
versions. Every entry point takes an explicit ``device``.

Importing the package turns TF32 off for float32 matmuls and cuDNN: TF32
keeps ~3 decimal digits, far below the fp32 accuracy class the engines
are held to.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import DEMO_CONFIG, LaserSpectrum, OpticsConfig, WavelengthScaling
from .grid import Grid
from .models.mask import (Mask, alternating_psm, attenuated_psm, contact_holes,
                          demo_bars, from_array, lines_and_spaces)
from .models.pupil import Pupil, pupil_function
from .models.source import LightSource
from .ops.abbe import SourcePoints, abbe_image, abbe_image_points, source_points
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
from .ops.perturb import ImagePerturbation, apply_perturbation
from .ops.vector import polarization_states, vector_abbe_image, vector_pupils
from .ops.zernike import osa_index_to_mn, wavefront_error, zernike_basis
from .simulate import SimulationResult, simulate, simulate_batch

__version__ = "0.1.0"

__all__ = [
    "DEMO_CONFIG",
    "Grid",
    "ImagePerturbation",
    "LaserSpectrum",
    "LightSource",
    "Mask",
    "OpticsConfig",
    "Pupil",
    "SOCSKernels",
    "SimulationResult",
    "SourcePoints",
    "WavelengthScaling",
    "abbe_image",
    "abbe_image_points",
    "alternating_psm",
    "apply_perturbation",
    "attenuated_psm",
    "auto_rank_socs",
    "chromatic_aberrations",
    "contact_holes",
    "demo_bars",
    "focus_stack_aberrations",
    "from_array",
    "lines_and_spaces",
    "mask_spectrum",
    "osa_index_to_mn",
    "polarization_states",
    "principal_channel_rotation",
    "pupil_function",
    "randomized_socs",
    "randomized_socs_chromatic",
    "randomized_socs_components",
    "randomized_socs_vector",
    "simulate",
    "simulate_batch",
    "socs_energy_captured",
    "socs_image",
    "socs_image_nrms_bound",
    "source_points",
    "spectrum_direct",
    "spectrum_fft",
    "tcc_eigensystem",
    "tcc_total_trace",
    "through_focus_images",
    "vector_abbe_image",
    "vector_pupils",
    "wavefront_error",
    "zernike_basis",
]
