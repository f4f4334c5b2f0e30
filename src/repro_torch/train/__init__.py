"""Serving steps and the batched server of the port."""
