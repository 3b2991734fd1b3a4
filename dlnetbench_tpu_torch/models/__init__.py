"""The dense gated transformer: layers, config and weights."""
