"""Input data of the PyTorch port."""
