"""Generation pipelines."""
