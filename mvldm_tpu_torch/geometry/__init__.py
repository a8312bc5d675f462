"""geometry of the PyTorch port."""
