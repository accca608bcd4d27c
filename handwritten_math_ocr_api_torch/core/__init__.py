"""Configuration, tokenizer and device choice of the port."""
