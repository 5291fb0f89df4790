"""The plain reference that decides `correct`: NumPy and SciPy over the
benchmark's own inputs (pdnbench.inputs, pdnbench.frozen).  It imports
nothing of the program and takes nothing the program made."""
