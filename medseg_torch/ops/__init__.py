"""Device ops of the PyTorch port: sliding-window inference, post-transforms
and metrics."""
