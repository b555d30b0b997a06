"""Models of the port: encoder, decoder and their building blocks."""
