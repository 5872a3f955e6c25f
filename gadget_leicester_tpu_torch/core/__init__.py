"""Configuration, timeline, cosmology factors and particle state."""
