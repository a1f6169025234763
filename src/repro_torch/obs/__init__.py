"""Consensus telemetry."""
