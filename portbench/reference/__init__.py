"""The plain reference: each architecture's equations (``<architecture>.py``
here, reached through ``architectures/<architecture>.py``; UNETR's in
``unetr.py``), the Gaussian window blend, DiceCE and AdamW in plain PyTorch,
computed in float32 (or, for the control, with every matmul and conv operand
rounded to fp8). It imports nothing of the program under test and takes
nothing the program made: the weights, volumes and batches come from the
benchmark's own generators."""
