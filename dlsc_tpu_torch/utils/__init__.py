"""Accounting helpers (MFU)."""
