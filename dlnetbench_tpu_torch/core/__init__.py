"""Architecture cards (the port's copy)."""
