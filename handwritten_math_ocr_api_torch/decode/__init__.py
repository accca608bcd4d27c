"""Greedy, beam, sampled, constrained, streamed and continuous decoding and
the DecodeEngine of the port."""
