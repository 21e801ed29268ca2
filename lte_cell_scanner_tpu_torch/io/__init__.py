"""Capture acquisition: recorded files, the synthetic source, record and
replay sessions, and the E4000 tuner's frequency model."""
