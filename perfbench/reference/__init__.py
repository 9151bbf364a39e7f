"""The plain reference of the benchmark's cells (float32 PyTorch; imports
nothing of the program)."""
