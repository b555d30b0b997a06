"""Generation side of the decoder trainer (the training steps come with a later slice)."""
