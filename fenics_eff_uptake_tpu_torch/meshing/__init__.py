"""Own mesher + mesh data structures (replace Gmsh/meshio/dolfin Mesh);
the port's copy of the JAX package's ``meshing`` (without its .msh reader
and writer, which no path of the port uses)."""

from .generator import MeshGenerator, generate_mesh, structured_rectangle
from .geometry import SulcusGeometry
from .mesh_data import MARKERS, MeshData
