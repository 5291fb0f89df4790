"""The program's entry points that the traffic mixes drive, one module
each, found by the `entry` a mix's file names.

Each module defines `Entry(ctx)`: set-up in the constructor (inputs
from pdnbench.inputs, the program's own set-up), then `warm_up()`,
`request(i)` -> (answer, counters), `close()` (frees the program's
state) and `check(answers)` -> [(name, value, limit)], the comparison
with pdnbench.reference after the window.
"""
