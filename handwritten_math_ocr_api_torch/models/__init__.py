"""Swin-T encoder and transformer decoder of the port."""
