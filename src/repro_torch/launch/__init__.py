"""Step factories for serving."""
