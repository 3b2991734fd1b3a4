"""Small utilities of the torch package (timing, a free loopback
port)."""
