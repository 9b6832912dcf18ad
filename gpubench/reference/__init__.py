"""The plain reference of the trained models: loss, gradients (autograd) and
the AdamW update in fp32, in plain PyTorch.  It imports nothing of the
program and takes nothing the program has made: the benchmark hands it the
configuration, the weights it made from the seed and the token batches."""
