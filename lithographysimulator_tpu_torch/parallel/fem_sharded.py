"""Mesh-sharded focus-exposure-matrix (FEM) cell pass.

Port of ``lithographysimulator_tpu/parallel/fem_sharded.py``. The host FEM
(:func:`..metrology.tiled_fem`) images each focal plane and walks the
(focus, dose) grid with full feature-table metrology: the sign-off path.
This is its device-side fast screen: the (F, D) CD matrix in one pass over
a 2-D ('focus', 'source') mesh (:func:`.abbe_sharded.through_focus_sharded`:
planes over 'focus', source points summed over 'source'), the doses a
loop on the first device. Differentiable in the base aberrations (a
process-window-aware SMO objective).

Dose semantics are :func:`..metrology.tiled_fem`'s: every plane shares one
normalization (the stack's max), dose scales the normalized image, and
the profile is the resist's diffusion blur through its sigmoid. The CD is
the total printed width along a row cut (soft subpixel edges): the
feature CD for a cut across one feature, the summed width for several.
"""

from __future__ import annotations

import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from ..models.resist import ResistModel
from ..ops.zernike import DEFOCUS_OSA_INDEX
from .abbe_sharded import through_focus_sharded
from .mesh import Mesh


def row_cut_cd(profile_row: torch.Tensor, pixel_size: float) -> torch.Tensor:
    """Total printed width (nm) along soft developed-profile rows in
    [0, 1] (the last axis): the sum of the per-pixel occupancies. Exactly
    (end - start + 1) * pixel_size for a hard single run; soft sigmoid
    edges keep it differentiable."""
    return profile_row.sum(dim=-1) * pixel_size


def _focus_stack(base: torch.Tensor, defocus: torch.Tensor) -> torch.Tensor:
    """(F, A) aberrations: ``base`` with the defocus entry (OSA 4, nm)
    set to each value of ``defocus``, in the graph of ``base``."""
    if base.shape[0] < DEFOCUS_OSA_INDEX + 1:
        base = torch.nn.functional.pad(base, (0, DEFOCUS_OSA_INDEX + 1 - base.shape[0]))
    stack = base[None].repeat(defocus.shape[0], 1)
    stack[:, DEFOCUS_OSA_INDEX] = defocus
    return stack


def fem_cd_matrix_sharded(
    spectrum: torch.Tensor,
    base_aberrations,
    defocus_nm,
    doses,
    shifts,
    weights,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    resist: ResistModel | None = None,
    chunk: int = 4,
    solver: str = "gau23",
    engine: str = "auto",
    max_abs_shift: int | None = None,
    row: int | None = None,
) -> torch.Tensor:
    """(F, D) focus-exposure CD matrix (nm) on the mesh's first device
    over a 2-D ('focus', 'source') mesh. The ``defocus_nm`` count must
    divide over the focus axis; ``shifts``/``weights`` follow
    :func:`.abbe_sharded.padded_source_arrays`. ``base_aberrations`` may be
    a tensor that requires grad."""
    resist = resist or ResistModel()
    first = mesh.first
    base = to_tensor(base_aberrations, device=first, dtype=torch.float32)
    defocus = to_tensor(defocus_nm, device=first, dtype=torch.float32).reshape(-1)
    stack = through_focus_sharded(
        spectrum, _focus_stack(base.reshape(-1), defocus), shifts, weights,
        config, mesh, solver=solver, chunk=chunk, engine=engine,
        max_abs_shift=max_abs_shift)  # (F, n, n)
    # one shared scale over the planes: a scale a plane would hide the
    # through-focus contrast loss the FEM measures (tiled_fem)
    norm = stack / torch.clamp(stack.max(), min=1e-30)
    blurred = resist.blur(norm, config)
    cut = blurred[:, config.n // 2 if row is None else row]  # (F, n)
    doses = to_tensor(doses, device=first, dtype=torch.float32).reshape(-1)
    profile = torch.sigmoid(resist.steepness
                            * (cut[:, None] * doses[None, :, None]
                               - resist.threshold))  # (F, D, n)
    return row_cut_cd(profile, config.pixel_size)
