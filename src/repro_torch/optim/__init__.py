"""Optimizers (AdamW, Adafactor) updating parameter trees in place."""
