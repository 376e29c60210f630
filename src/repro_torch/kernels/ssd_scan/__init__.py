"""Mamba-2 SSD chunked scan (plain versions + Hopper kernel)."""
