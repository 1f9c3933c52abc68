"""Plain PyTorch references the program is held to; they import nothing of
the program."""
