"""Own mesher + mesh data structures (replace Gmsh/meshio/dolfin Mesh);
the port's copy of the JAX package's ``meshing``."""

from .generator import MeshGenerator, generate_mesh, structured_rectangle
from .geometry import SulcusGeometry
from .mesh_data import MARKERS, MeshData
from .msh_io import mesh_from_msh2, read_msh2, write_msh2
