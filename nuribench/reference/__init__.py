"""The plain reference: NumPy and Python only.  It imports nothing of the
program and takes nothing the program made: it reads the data graph's edge
list, and judges the program's responses."""
