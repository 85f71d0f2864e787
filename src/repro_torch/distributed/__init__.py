"""Explicit collectives of the mesh path (``a2a``)."""
