"""Plain references: textbook PyTorch that imports nothing of the program."""
