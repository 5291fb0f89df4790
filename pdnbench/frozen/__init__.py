"""Frozen copies of the port's JAX-free host pipeline and of the test
suite's board generator, from which the benchmark makes its inputs.

units, sexp, utils/validation, geom, problem, mesh, kicad, native (with
its C++ sources, built by g++ into native/build/ here as
libpdnbench_geom_*), assembly (the host half of ops/assembly), system
(the host half of solver.build_system) and boardgen (tests/boardgen).
Imports stay inside this folder: nothing here imports the program.
"""
