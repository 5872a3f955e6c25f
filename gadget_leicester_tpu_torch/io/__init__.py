"""Snapshot files, state <-> snapshot conversion and restart dumps."""
