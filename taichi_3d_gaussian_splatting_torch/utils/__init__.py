"""Logging helpers."""
