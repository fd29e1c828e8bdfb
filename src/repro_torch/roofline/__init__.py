"""Roofline terms from static stage costs and from the dry run's records
(port of ``repro.roofline``), against the H100's rates
(``launch.mesh.HW``)."""

from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineTerms,
    analyze_cell,
    analyze_file,
    format_table,
    stage_roofline,
)
from repro_torch.roofline.attn_model import flash_attn_cost  # noqa: F401
