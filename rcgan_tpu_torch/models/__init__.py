"""Model definitions."""
