"""The plain reference the benchmark judges the program by: the sampler,
the models, the loss and Adam in plain PyTorch, with no kernel and nothing
of the program."""
