"""Optimizers of the port: AdamW, written by hand (`adamw.py`)."""
