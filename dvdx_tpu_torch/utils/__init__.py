"""Weight bridge and test helpers."""
