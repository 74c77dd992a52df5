"""Data helpers (only the padding math serving needs, so far)."""
