"""Plain PyTorch references of the benchmark's operations. They import
nothing of the program and take only the inputs the benchmark draws."""
