"""Rays × samples split over several processes, and scene gradients."""
