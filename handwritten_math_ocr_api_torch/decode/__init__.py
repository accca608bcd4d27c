"""Greedy decoding and the DecodeEngine of the port."""
