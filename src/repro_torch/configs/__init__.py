"""Experiment configurations."""
