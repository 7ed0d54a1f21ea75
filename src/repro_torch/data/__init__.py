"""Synthetic data pipeline (the twin of :mod:`repro.data`)."""
