"""Frozen copies of the inputs' generators: numpy only, so that the
reference and the harness build the same data from a seed without the
program."""
