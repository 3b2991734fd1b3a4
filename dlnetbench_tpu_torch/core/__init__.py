"""Architecture cards, hardware presets, the roofline, stats files, the
schedule algebra and build-time warming of step programs (the port's
copies)."""
