"""Model assembly for the port (dense family in this slice)."""
