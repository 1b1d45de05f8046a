"""Logging helpers and params snapshots."""
