"""The plain reference: UNETR's equations, the Gaussian window blend, DiceCE
and AdamW in plain PyTorch, computed in float32 (or, for the control, with
every matmul and conv operand rounded to fp8). It imports nothing of the
program under test and takes nothing the program made: the weights, volumes
and batches come from the benchmark's own generators."""
