"""Model zoo (port). This slice carries the decoder-only LM (``gpt``):
its serving half and its training configuration."""
