"""Engine of the PyTorch port: the weight bridge and the validator."""
