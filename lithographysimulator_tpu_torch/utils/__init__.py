"""Profiling helpers and artifact persistence (the JAX package's
``utils`` names; its complex-transfer helpers have no counterpart)."""

from .artifacts import (
    SOCSCache,
    config_fingerprint,
    load_image,
    load_socs,
    save_image,
    save_socs,
)
from .profiling import StageTimer, annotate, device_info, trace
