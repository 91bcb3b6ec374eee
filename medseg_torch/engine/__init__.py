"""Engine of the PyTorch port: the weight bridge, the validator, the train
state, the training step and loop."""
