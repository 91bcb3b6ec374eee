"""Device ops of the PyTorch port: sliding-window inference, post-transforms,
metrics and losses."""
