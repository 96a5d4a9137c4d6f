"""PyTorch/CUDA port of lithographysimulator_tpu: the exact-Abbe slice.

Scalar, monochromatic, thin-mask aerial imaging with the Gau'23 and direct
solvers, on a CUDA device through hand-written int8 limb kernels
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
from .ops.fraunhofer import mask_spectrum, spectrum_direct, spectrum_fft
from .ops.zernike import osa_index_to_mn, wavefront_error, zernike_basis
from .simulate import SimulationResult, simulate

__version__ = "0.1.0"

__all__ = [
    "DEMO_CONFIG",
    "Grid",
    "LaserSpectrum",
    "LightSource",
    "Mask",
    "OpticsConfig",
    "Pupil",
    "SimulationResult",
    "SourcePoints",
    "WavelengthScaling",
    "abbe_image",
    "abbe_image_points",
    "alternating_psm",
    "attenuated_psm",
    "contact_holes",
    "demo_bars",
    "from_array",
    "lines_and_spaces",
    "mask_spectrum",
    "osa_index_to_mn",
    "pupil_function",
    "simulate",
    "source_points",
    "spectrum_direct",
    "spectrum_fft",
    "wavefront_error",
    "zernike_basis",
]
