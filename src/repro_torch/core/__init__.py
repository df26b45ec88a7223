"""AltUp core of the PyTorch port: predict, correct and the stream
widening around them."""
