"""Parameter naming and initializers."""
