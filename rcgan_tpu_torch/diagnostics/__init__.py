"""Diagnostics run on the card by hand, beside ``chip_smoke.py``."""
