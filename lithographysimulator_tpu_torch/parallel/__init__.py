"""Multi-device imaging over a mesh of ``torch.device`` entries: the JAX
package's ``parallel`` names (one process, one call, the whole result
back on the mesh's first device) and the seven-pattern dry run."""

from .abbe_sharded import abbe_image_sharded, padded_source_arrays, through_focus_sharded
from .fem_sharded import fem_cd_matrix_sharded
from .film_sharded import film_images_sharded, film_stack_sharded
from .mesh import FOCUS_AXIS, SOURCE_AXIS, Mesh, focus_source_mesh, source_mesh
from .socs_build_sharded import (
    randomized_socs_components_sharded,
    randomized_socs_sharded,
)
from .socs_sharded import pad_socs_rank, socs_image_sharded
from .stochastic_sharded import (print_probability_sharded,
                                print_probability_volume_sharded)
from .tiled_sharded import tiled_socs_image_sharded
from .distributed import initialize as initialize_distributed


def __getattr__(name):
    # imported on first use, so `python -m ...parallel.dryrun` runs the
    # module once
    if name == "dryrun_multichip":
        from .dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
