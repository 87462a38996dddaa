"""The plain reference of the benchmark's models (model.py): plain PyTorch
in float32, with no kernel, cache or batching, and nothing of the program
under test imported."""
