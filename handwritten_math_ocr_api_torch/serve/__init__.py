"""The serving engines between request handlers and the decoders."""
