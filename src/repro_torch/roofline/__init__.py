"""Roofline terms from static stage costs (port of ``repro.roofline``),
against the H100's rates (``launch.mesh.HW``)."""

from repro_torch.roofline.analysis import stage_roofline  # noqa: F401
