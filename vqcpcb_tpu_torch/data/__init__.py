"""Data of the port: port-local NumPy copies of the JAX package's
vocabulary, tokenizer, synthetic corpus, window dataset and CPC data
loaders."""
