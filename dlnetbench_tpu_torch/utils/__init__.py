"""Small utilities of the torch package (timing)."""
