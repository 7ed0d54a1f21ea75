"""Cluster performance-model substrate: specs, simulator, fail-slow injector."""
