"""Serving-side pieces the engine shares: the speculative accept rule."""
