"""One driver per kind of loop, named by a cell's ``driver``."""
