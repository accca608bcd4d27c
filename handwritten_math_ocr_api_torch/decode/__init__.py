"""Greedy, beam and continuous decoding and the DecodeEngine of the port."""
