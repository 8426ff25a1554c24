"""Configuration and retrieval metrics."""
