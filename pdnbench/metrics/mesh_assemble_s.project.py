"""mesh_assemble_s.project: solver.solve's host pipeline seconds a
project (stats["mesh_assemble_s"]: connectivity, meshing, assembly),
mean over the window."""


def read(run):
    return run.mean("mesh_assemble_s")
