"""Model modules of the PyTorch port (NCDHW ``nn.Module`` counterparts of
``medseg.models``)."""
