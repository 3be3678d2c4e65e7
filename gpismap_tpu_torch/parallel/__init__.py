from .mesh import Mesh, data_mesh, sharded_map_test  # noqa: F401
