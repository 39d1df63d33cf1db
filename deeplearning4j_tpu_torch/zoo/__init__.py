"""Model zoo (port). This slice carries the decoder-only LM's serving
half (``gpt``)."""
