"""Model layers, assembly and decode of the PyTorch port."""
