"""The train step of the PyTorch port: state, optimizer and step."""
