"""Roofline machinery of the port: the work of each kernel call
(``work``), the counters of a traced step (``counters``) and the roofline
terms (``analysis``, a copy of ``repro/roofline/analysis.py`` with the
H100's constants)."""

from repro_torch.roofline.analysis import (collective_bytes_moved,
                                           roofline_terms)

__all__ = ["collective_bytes_moved", "roofline_terms"]
